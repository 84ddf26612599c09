"""The harness finds cells, configurations, model types, traffic mixes and
metrics by the names in BENCHMARK.json, and a new one is added by new
files and new entries alone."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, weights
from portbench.reference import check, model
from portbench.tests.conftest import TINY, tiny_overrides

ROOT = harness.ROOT
TOY = ROOT / "portbench" / "tests" / "toy_lm"


def spec():
    return harness.spec_of()


def test_every_name_has_its_files():
    s = spec()
    for w in s["workloads"]:
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").exists()
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        ctx = harness.context(w["name"], 1, 1.0, False, device="cpu")
        assert (ROOT / "portbench" / "kinds"
                / f"{ctx.traffic['kind']}.py").exists()
    for c in s["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
        kind = harness.load_json(ROOT / c["file"])["model_type"]
        assert (ROOT / "portbench" / "models" / f"{kind}.py").exists()
    for m in s["end_to_end"] + s["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_reports_setup_an_e2e_and_a_layer_metric(trace):
    s = spec()
    for w in s["workloads"]:
        ctx = harness.context(w["name"], 1, 1.0, bool(trace), device="cpu")
        names = [m["name"] for m in harness.metrics_for(ctx)]
        if trace:
            assert names
            moved = {m["moves"] for m in harness.metrics_for(ctx)}
            e2e = {m["name"] for m in s["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])}
            assert moved <= e2e
        else:
            assert "setup_s" in names and len(names) >= 2


def test_config_files_hold_the_published_sizes():
    """Each configuration file's sizes are the program's preset's, as its
    model type pairs them."""
    for w in spec()["workloads"]:
        ctx = harness.context(w["name"], 1, 1.0, False, device="cpu")
        pairs = harness.model_of(ctx).preset_pairs(ctx)
        assert [k for k, _, _ in pairs] == [
            "d_model", "encoder_attention_heads", "encoder_layers",
            "decoder_layers", "num_mel_bins", "vocab_size", "encoder_ffn_dim",
            "eos_token_id", "decoder_start_token_id", "transcribe_token_id",
            "prev_sot_token_id", "no_timestamps_token_id"]
        for key, in_file, in_preset in pairs:
            assert in_file == in_preset, (w["name"], key)


@pytest.mark.parametrize("model_type", [None, "no_such_model"])
def test_a_missing_model_type_is_named(model_type):
    ctx = harness.context("medium.batch64", 1, 1.0, False, device="cpu")
    if model_type is None:
        del ctx.config["model_type"]
        with pytest.raises(KeyError, match="medium.*has no.*model_type"):
            harness.model_of(ctx)
    else:
        ctx.config["model_type"] = model_type
        with pytest.raises(FileNotFoundError,
                           match="'no_such_model' of configuration 'medium'"):
            harness.model_of(ctx)


def test_judge_through_the_model_type_reads_as_the_direct_calls():
    """judge() draws the weights and runs the reference through the
    configuration's model type; its numbers are, to the last digit, those
    of `weights.make` and `reference.model.served_logits` called
    directly (tiny's width, one seed)."""
    seed = 2 ** 31 + 21
    ctx = harness.context("medium.batch64", seed, 0.1, False, device="cpu",
                          overrides=tiny_overrides("medium.batch64"))
    assert harness.model_of(ctx).make is weights.make
    prompt = [50258, 50259, 50359, 50363]
    smp = {"audio": weights.audio_pool(2, 480_000, 16_000, seed, "cpu"),
           "prompts": [prompt, prompt],
           "served": [[400, 500, 600, 700], [11, 12, 13]],
           "banned_ids": [50257], "banned_from": None}
    obs: dict = {}
    checks = harness.judge(ctx, obs, smp)
    cfg = ctx.config
    w = weights.make(cfg, seed, "cpu", torch.bfloat16)
    refs = model.served_logits(w, cfg, smp["audio"], smp["prompts"],
                               smp["served"], {}, "cpu")
    ok = check.allowed_mask(cfg["vocab_size"], [50257], None, "cpu")
    want = check.served_numbers(refs, smp["served"], ok)
    assert obs["reference"] == want
    assert checks["err2"]["value"] == want["err2"]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_traffic_and_metric_added_by_files_alone(tmp_path):
    """In a copy of the benchmark, a new configuration (tiny), traffic mix,
    cell and per-layer metric are added as new files and new entries of
    BENCHMARK.json; the harness runs the new cell and reads the new
    metric, and no file that was there changed but BENCHMARK.json's
    additions."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")

    pb = tmp_path / "portbench"
    base = json.loads((pb / "configs" / "medium.json").read_text())
    (pb / "configs" / "tiny.json").write_text(json.dumps({**base, **TINY}))
    traffic = json.loads((pb / "traffic" / "batch_windows.json").read_text())
    traffic.update(max_new=3, pool_batches=1)
    (pb / "traffic" / "short_batches.json").write_text(json.dumps(traffic))
    cell = json.loads((pb / "cells" / "medium.batch64.json").read_text())
    cell.update(model="tiny", batch=2, sample={"rows": 2})
    (pb / "cells" / "tiny.batch2.json").write_text(json.dumps(cell))
    (pb / "metrics" / "rows_per_s.batch.py").write_text(
        "def read(obs):\n"
        "    if obs.get('kind') != 'closed_loop':\n"
        "        return None\n"
        "    return obs['attempted'] / (obs['t_end'] - obs['t0'])\n")
    s = json.loads((tmp_path / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "tiny", "source": "https://huggingface.co/"
                         "openai/whisper-tiny/blob/main/config.json",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "tiny.batch2", "config": "tiny",
                           "traffic": "short_batches", "chips": 1,
                           "why": "test"})
    s["end_to_end"][[m["name"] for m in s["end_to_end"]].index("rtfx")][
        "workloads"].append("tiny.batch2")
    s["per_layer"].append({"name": "rows_per_s.batch", "unit": "rows/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "rtfx",
                           "workloads": ["tiny.batch2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())

    ctx = harness.context("tiny.batch2", 7, 0.1, False, device="cpu",
                          root=tmp_path)
    line = harness.run(ctx, 0.0)
    assert line["correct"] and set(line["metrics"]) == {"rtfx", "setup_s"}
    ctx = harness.context("tiny.batch2", 7, 0.1, True, device="cpu",
                          root=tmp_path)
    obs = {"kind": "closed_loop", "attempted": 4, "t0": 1.0, "t_end": 3.0}
    assert harness.read_metrics(ctx, obs)["rows_per_s.batch"]["value"] == 2.0


def test_overrides_reach_each_file():
    ov = tiny_overrides("turbo.engine32")
    ctx = harness.context("turbo.engine32", 1, 1.0, False, device="cpu",
                          overrides=ov)
    assert ctx.config["d_model"] == 384 and ctx.cell["model"] == "tiny"
    assert ctx.traffic["max_new"] == 20
    assert ctx.traffic["kind"] == "open_loop"


TOY_CELL = "toy_lm.batch16"


def in_copy(root: Path, *args: str) -> list:
    """`python3 <args>` from the root of a copy of the benchmark, so that
    `portbench` there is the copy's: the JSON lines it prints."""
    env = {**os.environ, "USE_FLAX": "0", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]


@pytest.fixture(scope="module")
def toy_copy(tmp_path_factory):
    """A copy of the benchmark with a model type that is not Whisper
    (`portbench/tests/toy_lm/`: an audio-prefix language model with GQA,
    RoPE, RMSNorm and a SiLU-gated MLP) added as new files, laid over the
    copy's `portbench/`, and three new entries of BENCHMARK.json: its
    configuration, its cell, and the cell under `rtfx`'s workloads.
    Returns (root, digest of portbench before, digest after)."""
    root = tmp_path_factory.mktemp("toy")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "portbench")
    added = _digest(TOY)
    assert not set(added) & set(before)
    shutil.copytree(TOY, root / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "toy_lm", "source": "a toy model",
                         "file": "portbench/configs/toy_lm.json",
                         "reduced": [], "why": "a model type not Whisper"})
    s["workloads"].append({"name": TOY_CELL, "config": "toy_lm",
                           "traffic": "toy_prompts", "chips": 1,
                           "why": "batches of 16 through the toy program"})
    next(m for m in s["end_to_end"] if m["name"] == "rtfx")[
        "workloads"].append(TOY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return root, before, _digest(root / "portbench")


def test_a_model_type_added_by_files_alone(toy_copy):
    """The toy model type's cell runs on the CPU in the copy: `correct`
    true with `rtfx` and `setup_s` read, and false where an override makes
    the program serve altered tokens. No file that was there changed;
    BENCHMARK.json only gained entries."""
    root, before, after = toy_copy
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == set(_digest(TOY))
    code = (
        "import json\n"
        "from portbench import harness\n"
        "for alter in (0, 7):\n"
        f"    ctx = harness.context({TOY_CELL!r}, 2 ** 31 + 41, 0.2, False,\n"
        "                          device='cpu',\n"
        "                          overrides={'cell': {'alter': alter}})\n"
        "    print(json.dumps(harness.run(ctx, 0.0)))\n")
    sound, altered = in_copy(root, "-c", code)
    assert sound["correct"], sound["checks"]
    assert set(sound["metrics"]) == {"rtfx", "setup_s"}
    assert not altered["correct"], altered["checks"]
    s = json.loads((root / "BENCHMARK.json").read_text())
    old = spec()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len(s[key]) == len(old[key]) + (key in ("configs",
                                                        "workloads"))


def test_the_control_reads_a_new_model_type(toy_copy):
    """`python3 -m portbench.control` on the toy cell, in the copy, on the
    CPU: the program reads inside the cell's limits on every seed and its
    control (the toy program in bf16) outside one."""
    root, _, _ = toy_copy
    seeds = [2 ** 31 + 51, 2 ** 31 + 52, 2 ** 31 + 53]
    got = in_copy(root, "-m", "portbench.control", "--workload", TOY_CELL,
                  "--seeds", ",".join(map(str, seeds)), "--seconds", "0.2",
                  "--device", "cpu")
    limits = harness.load_json(TOY / "cells" / f"{TOY_CELL}.json")["limits"]
    assert [g["seed"] for g in got] == seeds
    for g in got:
        assert all(g["program"][k] <= v for k, v in limits.items()), g
        assert any(g["control"][k] > v for k, v in limits.items()), g
