"""The window arithmetic, the tails, the idle share, the traffic drawn
from the seed, and the FLOP and byte counts against hand counts."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from portbench import costs, harness, stats, trace
from portbench.reference import check
from portbench.kinds import closed_loop, open_loop


def config(name: str) -> dict:
    return harness.load_json(harness.ROOT / "portbench" / "configs"
                             / f"{name}.json")


def traffic(name: str) -> dict:
    return harness.load_json(harness.ROOT / "portbench" / "traffic"
                             / f"{name}.json")


# ---- traffic ----------------------------------------------------------------

def test_schedule_is_reproduced_from_the_seed():
    tr = traffic("poisson_longform")
    a = open_loop.schedule(tr, 5.0, 40.0, 2 ** 31 + 11)
    b = open_loop.schedule(tr, 5.0, 40.0, 2 ** 31 + 11)
    c = open_loop.schedule(tr, 5.0, 40.0, 2 ** 31 + 12)
    assert a == b and a != c


def test_every_seed_offers_the_same_sizes_and_arrivals():
    """Inter-arrival gaps and prompt lengths are one multiset in another
    order: the exponential's quantiles, the mix's evenly spaced lengths."""
    tr = traffic("poisson_longform")
    runs = [open_loop.schedule(tr, 5.0, 40.0, s) for s in (1, 2, 3)]
    for r in runs:
        assert len(r) == 200
        due = np.array([x["due"] for x in r])
        assert np.all(np.diff(due) > 0) and due[-1] < 40.0
        lens = sorted(len(x["prev"]) for x in r if x["prev"])
        assert len(lens) == 100 and lens[0] == 16 and lens[-1] == 219
    gaps = [sorted(np.diff([0.0] + [x["due"] for x in r]).round(9))
            for r in runs]
    assert gaps[0] == gaps[1] == gaps[2]
    lens = [sorted(len(x["prev"]) for x in r if x["prev"]) for r in runs]
    assert lens[0] == lens[1] == lens[2]
    # a Poisson process's gaps: mean 1 / rate, coefficient of variation 1
    g = np.diff([0.0] + [x["due"] for x in runs[0]])
    assert abs(g.mean() - 0.2) < 0.01 and abs(g.std() / g.mean() - 1) < 0.1


def test_buckets_and_prompts():
    cfg = config("large-v3-turbo")
    assert open_loop.buckets_of(cfg, traffic("poisson_longform")) == \
        (8, 32, 64, 128, 256)
    assert open_loop.prompt_ids(cfg, None) == [50258, 50259, 50360, 50364]
    assert open_loop.prompt_ids(cfg, [7, 8])[:3] == [50362, 7, 8]


# ---- tails over all requests ------------------------------------------------

def engine_obs() -> dict:
    reqs = []
    for i in range(20):
        due = float(i)
        toks = [due + 0.1 + 0.01 * k for k in range(5)]
        reqs.append({"due_abs": due, "ttft": 0.1, "toks": toks,
                     "admit": due + 0.05, "refused": False, "ids": [1]})
    reqs[3].update(refused=True, ttft=100.0, toks=[], admit=None, ids=None)
    return {"kind": "open_loop", "requests": reqs, "t_end": 103.0,
            "steps": [(0.0, 0.3, 2), (0.3, 0.31, 0), (0.31, 0.33, 0),
                      (0.33, 0.63, 1)], "slots": 4}


def test_tails_take_every_request_and_a_failure_misses():
    obs = engine_obs()
    read = {m: harness.load_module(harness.ROOT / "portbench" / "metrics"
                                   / f"{m}.py").read
            for m in ("ttft_p95_ms", "gap_p95_ms", "queue_wait_p95_ms.engine",
                      "fill_ms.engine", "token_step_ms.engine",
                      "fill_useful_rows.engine", "rtfx")}
    ttft = [r["ttft"] for r in obs["requests"]]
    assert read["ttft_p95_ms"](obs) == pytest.approx(
        1e3 * np.percentile(ttft, 95))
    assert read["ttft_p95_ms"](obs) > 100       # the refused one reaches p95
    assert read["gap_p95_ms"](obs) == pytest.approx(10.0)
    assert len(stats.gaps(obs)) == 19 * 4
    waits = [0.05] * 19 + [103.0 - 3.0]
    assert read["queue_wait_p95_ms.engine"](obs) == pytest.approx(
        1e3 * np.percentile(waits, 95))
    assert read["fill_ms.engine"](obs) == pytest.approx(300.0)
    assert read["token_step_ms.engine"](obs) == pytest.approx(15.0)
    assert read["fill_useful_rows.engine"](obs) == pytest.approx(37.5)
    assert read["rtfx"](obs) is None


# ---- whole batches ----------------------------------------------------------

class FakeBatches:
    """closed_loop's program with a batch that takes 0.05 s."""

    def __init__(self):
        self.pool = np.zeros((2, 3, 10), np.float32)
        self.prompt = [1, 2, 3, 4]
        self.max_new = 3
        self.calls = 0

    def batch(self, audio):
        import time
        time.sleep(0.05)
        self.calls += 1
        return np.tile(np.array([1, 2, 3, 4, 9, 9, 9, 9]), (3, 1))


def test_the_window_runs_whole_batches():
    ctx = types.SimpleNamespace(
        cell={"batch": 3, "trace": {"batch": 0}}, config=config("medium"),
        traffic={"audio_s": 30}, trace=False, seconds=0.12, device="cpu",
        note=lambda s: None)
    prog = FakeBatches()
    obs = closed_loop.window(ctx, prog)
    assert prog.calls == 3             # 0.05, 0.10, then 0.15 > 0.12
    assert obs["t_end"] - obs["t0"] >= 0.12
    assert obs["audio_s"] == 3 * 3 * 30
    rtfx = harness.load_module(harness.ROOT / "portbench" / "metrics"
                               / "rtfx.py").read(obs)
    assert rtfx == pytest.approx(270 / (obs["t_end"] - obs["t0"]))
    assert obs["counts"]["prompt_mismatch"] == 0


# ---- idle share from kernel intervals ---------------------------------------

class Ev:
    def __init__(self, name, dev, act, s, e, corr=0, link=0):
        self._v = (name, dev, act, s, e, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return types.SimpleNamespace(name=self._v[1])

    def activity_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def fake_prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_idle_share_groups_and_gaps_from_kernel_intervals():
    ev = [
        Ev("flash_kernel", "CUDA", "kernel", 100, 150),
        Ev("tile_kernel<I8, 1>", "CUDA", "kernel", 150, 350),
        Ev("flash_kernel", "CUDA", "kernel", 400, 450),   # not the tail's
        Ev("Memcpy DtoH", "CUDA", "gpu_memcpy", 700, 800),
        Ev("pb.x", "CUDA", "gpu_user_annotation", 0, 900),
        Ev("cudaStreamSynchronize", "CPU", "cuda_runtime", 430, 600),
    ]
    host = [(0, 500, "step.fill"), (500, 1000, "wait for arrivals")]
    tail = (["tile_kernel", "ln_kernel", "quant_rows"], ["flash_kernel"])
    r = trace.reduce(fake_prof(ev), 0, 1000, host, {"tail": tail})
    assert r["window_s"] == pytest.approx(1000e-9)
    # [100, 350) + [400, 450) + [700, 800)
    assert r["busy_s"] == pytest.approx(400e-9)
    assert stats.idle_pct({"kind": "k", "trace": r}, "k") == \
        pytest.approx(60.0)
    assert r["groups"]["tail"] == {"device_s": pytest.approx(250e-9),
                                   "calls": 1}
    assert r["idle_gaps"] == [
        ["step.fill > cudaStreamSynchronize", pytest.approx(250e-9)],
        ["wait for arrivals", pytest.approx(200e-9)],
        ["step.fill", pytest.approx(100e-9)],
        ["step.fill", pytest.approx(50e-9)]]
    assert [n for n, _ in r["device_ops"]] == [
        "tile_kernel<I8, 1>", "flash_kernel", "Memcpy DtoH"]
    r["tail_bound_s"] = 125e-9
    assert stats.tail_roofline_pct({"kind": "k", "trace": r}, "k") == \
        pytest.approx(50.0)


# ---- operations and bytes against hand counts -------------------------------

@pytest.mark.parametrize("name,int8", [("large-v3-turbo", True),
                                       ("medium", False)])
def test_tail_work_by_hand(name, int8):
    cfg = config(name)
    d, ff, t, rows = cfg["d_model"], cfg["encoder_ffn_dim"], 1500, 32
    w = costs.tail_work(cfg, rows, int8)
    attn = 2 * 2 * rows * t * t * d          # QK^T and PV, 2 ops a MAC
    mm = 2 * rows * t * (d * d + d * ff + ff * d)
    if int8:
        assert (w["bf16_ops"], w["int8_ops"]) == (attn, mm)
        # turbo at 32 rows: 0.373 ms of attention + 0.715 ms of int8 ops,
        # chip_smoke's tail_q8_bound (PERF.md's kernel table: 1.088)
        assert costs.bound_s(w) == pytest.approx(
            attn / 989e12 + mm / 1979e12)
        assert costs.bound_s(w) * 1e3 == pytest.approx(1.088, abs=0.001)
    else:
        assert (w["bf16_ops"], w["int8_ops"]) == (attn + mm, 0)
    moved = 5 * rows * t * d * 2 + (d * d + 2 * d * ff) * (1 if int8 else 2)
    assert moved < w["bytes"] < moved + 64 * d + 16 * ff


def test_model_flops_by_hand():
    cfg = config("medium")
    d, ff, v, t, L = 1024, 4096, 51865, 1500, 24
    enc_layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * ff
    stem = 2 * 3000 * d * 80 * 3 + 2 * t * d * d * 3
    assert costs.encoder_flops(cfg, 2) == 2 * (stem + L * enc_layer)
    step = L * (12 * d * d + 4 * 10 * d + 4 * t * d + 4 * d * ff) + 2 * d * v
    assert costs.decode_step_flops(cfg, 10, 3) == 3 * step
    pre = L * (8 * 4 * d * d + 4 * 16 * d + 4 * 4 * d * d + 4 * 4 * t * d
               + 4 * 4 * d * ff)
    assert costs.prefill_flops(cfg, 4, logits=False) == pre
    assert costs.prefill_flops(cfg, 4) == pre + 2 * 4 * d * v
    # a medium batch of 64 rows, 97 tokens: ~82 TFLOP of model work
    total = costs.batch_flops(cfg, 64, 4, 96)
    assert 75e12 < total < 90e12
    assert stats.mfu_pct(total, 4.0) == pytest.approx(
        100 * total / 4.0 / 989e12)


def test_the_last_line_has_the_contracts_keys(monkeypatch, capsys):
    """run.main prints the result with correct, attempted, failed,
    metrics, device (and checks last), the checks on standard error."""
    from portbench import run
    fake = {"correct": True, "attempted": 3, "failed": 0,
            "metrics": {"rtfx": {"value": 1.5, "unit": "audio_s/s"}},
            "device": {"platform": "gpu", "kind": "x", "count": 1,
                       "memory_peak_bytes": 1},
            "checks": {"gap_max": {"value": 0.1, "limit": 0.5}}}
    monkeypatch.setattr(harness, "run", lambda ctx, t: dict(fake))
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    assert run.main(["--workload", "medium.batch64", "--seed", "5",
                     "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert err.strip().splitlines()[-1] == "check gap_max 0.1 limit 0.5"


def test_no_result_without_a_card(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", "turbo.engine32", "--seed", "5",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


# ---- the comparison -----------------------------------------------------------

def _flip_sample(n: int, tie_every: int, delta: float, seed: int = 5):
    """Reference logits (n, 3) whose top-2 margins are 0.001-0.009 at every
    `tie_every`-th position and 1 elsewhere, and the picks of a program
    whose logit difference is off by `delta` against the best token."""
    rng = np.random.default_rng(seed)
    m = np.ones(n)
    m[::tie_every] = rng.uniform(0.001, 0.009, size=m[::tie_every].size)
    ref = np.zeros((n, 3), np.float32)
    ref[:, 0], ref[:, 1], ref[:, 2] = m, 0.0, -5.0
    picked = np.where(m < delta, 1, 0)
    import torch
    return [torch.from_numpy(ref)], [picked.tolist()], \
        torch.ones(3, dtype=torch.bool)


@pytest.mark.parametrize("tie_every, floored", [(4, False), (1000, True)])
def test_err2_reads_the_flips_over_the_near_ties(tie_every, floored):
    """With margins near 0 dense, err2 = 0.02 x mean gap / share under
    0.01; where they are sparse the share is floored, so the number can
    only read lower than the unfloored estimate."""
    refs, served, ok = _flip_sample(8000, tie_every, 0.005)
    got = check.served_numbers(refs, served, ok)
    share = got["margin_under_0.01"]
    assert (share < check.MIN_TIE_SHARE) == floored
    assert got["err2"] == pytest.approx(
        0.02 * got["gap_mean"] / max(share, check.MIN_TIE_SHARE))
    assert got["gap_max"] < 0.005 and got["not_best_share"] > 0

