"""The harness finds cells, configurations, traffic mixes and metrics by
the names in BENCHMARK.json, and a new one is added by new files and new
entries alone."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import TINY, tiny_overrides

ROOT = harness.ROOT


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
    """Each configuration file's sizes are the program's preset's."""
    from whisper_tpu_torch.config import get_config
    for w in spec()["workloads"]:
        ctx = harness.context(w["name"], 1, 1.0, False, device="cpu")
        p = get_config(ctx.cell["model"])
        c = ctx.config
        assert (c["d_model"], c["encoder_attention_heads"],
                c["encoder_layers"], c["decoder_layers"], c["num_mel_bins"],
                c["vocab_size"], c["encoder_ffn_dim"]) == (
            p.d_model, p.n_heads, p.n_audio_layers, p.n_text_layers,
            p.n_mels, p.vocab_size, p.d_ff)
        assert (c["eos_token_id"], c["decoder_start_token_id"],
                c["transcribe_token_id"], c["prev_sot_token_id"],
                c["no_timestamps_token_id"]) == (
            p.eot_token, p.sot_token, p.transcribe_token, p.sot_prev_token,
            p.no_timestamps_token)


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
