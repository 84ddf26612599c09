"""The window arithmetic, the tails, the idle share, the traffic drawn
from the seed, and the FLOP and byte counts against hand counts."""

from __future__ import annotations

import json
import math
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
            for m in ("ttft_p95_ms", "gap_p95_ms.engine",
                      "queue_wait_p95_ms.engine",
                      "fill_ms.engine", "token_step_ms.engine",
                      "fill_useful_rows.engine", "rtfx")}
    ttft = [r["ttft"] for r in obs["requests"]]
    assert read["ttft_p95_ms"](obs) == pytest.approx(
        1e3 * np.percentile(ttft, 95))
    assert read["ttft_p95_ms"](obs) > 100       # the refused one reaches p95
    assert read["gap_p95_ms.engine"](obs) == pytest.approx(10.0)
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
    def __init__(self, name, dev, act, s, e, corr=0, link=0, grid=None):
        self._v = (name, dev, act, s, e, corr, link)
        self.grid = grid

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


def fake_prof(events, chrome: bool = True):
    """A profiler over `events`; with `chrome`, its chrome trace holds each
    kernel's grid under its correlation id, as kineto writes CUPTI's
    kernel record."""
    def export(path):
        rows = [{"ph": "X", "cat": "kernel", "name": e.name(),
                 "ts": e.start_ns() / 1e3, "args": {
                     "queued": 0, "device": 0, "stream": 7,
                     "correlation": e.correlation_id(),
                     "registers per thread": 168, "grid": list(e.grid),
                     "block": [256, 1, 1]}}
                for e in events if e.grid is not None]
        with open(path, "w") as f:
            json.dump({"schemaVersion": 1, "traceEvents": rows}, f)

    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    if chrome:
        prof.export_chrome_trace = export
    return prof


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
    assert r["groups"]["tail"] == {
        "device_s": pytest.approx(250e-9), "calls": 1,
        "per_call": [{"device_s": pytest.approx(250e-9), "grid": None}]}
    assert r["idle_gaps"] == [
        ["step.fill > cudaStreamSynchronize", pytest.approx(250e-9)],
        ["wait for arrivals", pytest.approx(200e-9)],
        ["step.fill", pytest.approx(100e-9)],
        ["step.fill", pytest.approx(50e-9)]]
    assert [n for n, _ in r["device_ops"]] == [
        "tile_kernel<I8, 1>", "flash_kernel", "Memcpy DtoH"]
    r["groups"]["tail"]["per_call"][0]["bound_s"] = 125e-9
    assert stats.tail_roofline_pct({"kind": "k", "trace": r}, "k") == \
        pytest.approx(50.0)


# ---- kernel shares reckoned call by call ------------------------------------

TAIL = (["tile_kernel", "ln_kernel", "quant_rows"], ["flash_kernel"],
        "tile_kernel")
BM = 128


def tail_events(windows, per_window_ns: int) -> list:
    """One int8 tail call per entry of `windows` (flash, the row
    quantizer, the o-projection tile, LN2, FC1 and FC2 tiles), each taking
    per_window_ns a window, with other work between calls; the tile
    launches' grid.y is ceil(windows x 1500 / 128), the quantizer's grid
    1-D."""
    parts = [("flash_kernel<bf16>", 20), ("quant_rows", 5),
             ("tile_kernel<I8, 0>", 30), ("ln_kernel<bf16, 1>", 5),
             ("tile_kernel<I8, 1>", 25), ("tile_kernel<I8, 2>", 15)]
    ev, t = [], 0
    for w in windows:
        y = -(-w * 1500 // BM)
        for name, pct in parts:
            dur = w * per_window_ns * pct // 100
            grid = (10, y, 1) if "tile" in name else (y * 16, 1, 1)
            ev.append(Ev(name, "CUDA", "kernel", t, t + dur, corr=len(ev),
                         grid=grid))
            t += dur
        ev.append(Ev("elementwise_kernel", "CUDA", "kernel", t, t + 1000,
                     corr=len(ev)))
        t += 5000
    return ev


def tail_share(cfg, cell, windows, per_window_ns, chrome=True):
    ev = tail_events(windows, per_window_ns)
    r = trace.reduce(fake_prof(ev, chrome), 0, ev[-1].end_ns(), (),
                     {"tail": TAIL})
    stats.reckon_tail(r, cfg, cell)
    return r, stats.tail_roofline_pct({"kind": "k", "trace": r}, "k")


def test_windows_from_the_tail_grid():
    """grid.y = ceil(windows x 1500 / BM) gives back the windows, 1 to
    64; a grid.y that no window count gives reads None."""
    for w in range(1, 65):
        assert costs.windows_of(-(-w * 1500 // BM), BM, 1500) == w
    reached = {-(-w * 1500 // BM) for w in range(1, 80)}
    for y in set(range(0, 600)) - reached:
        assert costs.windows_of(y, BM, 1500) is None


@pytest.mark.parametrize("workload", ["turbo.engine32", "medium.batch64"])
def test_tail_share_counts_the_windows_each_call_encoded(workload):
    """Calls of 1, 2, 8 and 32 windows at one speed a window read the
    share that 32-window calls read at that speed, under 100%, where the
    slots' count per call would read ~3x higher, above 100%."""
    cell = harness.load_json(harness.ROOT / "portbench" / "cells"
                             / f"{workload}.json")
    cfg = config(harness.context(workload, 1, 1, False).workload["config"])
    int8 = bool(cell.get("policy", {}).get("enc_bits"))
    one = costs.bound_s(costs.tail_work(cfg, 1, int8))
    per_window = int(one / 0.4 * 1e9) // 100 * 100      # ~40% of its bound
    r, mixed = tail_share(cfg, cell, [1, 2, 8, 32], per_window)
    assert [c["windows"] for c in r["groups"]["tail"]["per_call"]] == \
        [1, 2, 8, 32]
    _, uniform = tail_share(cfg, cell, [32] * 4, per_window)
    assert mixed == pytest.approx(uniform, rel=1e-9)
    assert 39 < mixed < 41 and mixed < 100
    by_slots = (100.0 * costs.bound_s(costs.tail_work(cfg, 32, int8))
                * r["groups"]["tail"]["calls"] / r["groups"]["tail"]["device_s"])
    assert by_slots > 100


@pytest.mark.parametrize("workload,calls", [("turbo.engine32", 7),
                                            ("medium.batch64", 24)])
def test_uniform_calls_sum_to_the_slots_product(workload, calls):
    """Where every call encodes the cell's slots (as today's engine and
    batch do), the per-call sum is the bound of those rows x the calls."""
    cell = harness.load_json(harness.ROOT / "portbench" / "cells"
                             / f"{workload}.json")
    cfg = config(harness.context(workload, 1, 1, False).workload["config"])
    rows = cell.get("slots", cell.get("batch"))
    r, share = tail_share(cfg, cell, [rows] * calls, 90_000)
    int8 = bool(cell.get("policy", {}).get("enc_bits"))
    g = r["groups"]["tail"]
    old = costs.bound_s(costs.tail_work(cfg, rows, int8))
    assert math.fsum(c["bound_s"] for c in g["per_call"]) == old * calls
    assert share == pytest.approx(100.0 * old * g["calls"] / g["device_s"],
                                  rel=1e-12)


def test_a_tail_without_readable_windows_has_no_share():
    """No chrome trace (or a grid.y no window count gives): None, never a
    share from the cell's slots."""
    cell = harness.load_json(harness.ROOT / "portbench" / "cells"
                             / "turbo.engine32.json")
    cfg = config("large-v3-turbo")
    r, share = tail_share(cfg, cell, [32, 32], 90_000, chrome=False)
    assert r["groups"]["tail"]["calls"] == 2 and share is None
    ev = tail_events([4], 90_000)
    for e in ev:
        if "tile" in e.name():
            e.grid = (10, 5, 1)
    r = trace.reduce(fake_prof(ev), 0, ev[-1].end_ns(), (), {"tail": TAIL})
    stats.reckon_tail(r, cfg, cell)
    assert r["groups"]["tail"]["per_call"][0]["windows"] is None
    assert stats.tail_roofline_pct({"kind": "k", "trace": r}, "k") is None


def test_fused_step_bound_at_medium_b64():
    """PERF.md's kernel table: medium b64 bf16, 24 layers, 48 self rows
    cached: 3.120 ms, bound by its bytes (9.4 GB of cross K/V)."""
    cfg = config("medium")
    w = costs.fused_step_work(cfg, 64, 48)
    assert costs.bound_s(w) * 1e3 == pytest.approx(3.12, rel=0.005)
    assert w["bytes"] / costs.HBM_BYTES_PER_S > \
        w["bf16_ops"] / costs.PEAK_BF16
    d, L = 1024, 24
    assert w["bytes"] == (L * 14 * d * d * 2 + L * 17 * d * 4
                          + 2 * L * 64 * (1500 + 48) * d * 2
                          + 2 * 64 * d * 2 + 2 * L * 64 * d * 2)


def test_fused_step_share_is_reckoned_launch_by_launch():
    """Launch i of the traced batch at prompt_len + i cached rows; a trace
    with other than the loop's launches, or a cell not in bf16, has
    no share."""
    cfg = config("medium")
    cell = {"batch": 64, "dtype": "bfloat16"}
    ev, t = [], 0
    for i in range(6):
        ev.append(Ev("fused_step_kernel<bf16>", "CUDA", "kernel", t,
                     t + 6_300_000))
        ev.append(Ev("gemm", "CUDA", "kernel", t + 6_300_000,
                     t + 6_400_000))
        t += 7_000_000
    r = trace.reduce(fake_prof(ev), 0, t, (), None,
                     {"fused_step": "fused_step_kernel"})
    assert r["launches"]["fused_step"] == [pytest.approx(6.3e-3)] * 6
    stats.reckon_fused(r, cfg, cell, 4, 6)
    want = sum(costs.bound_s(costs.fused_step_work(cfg, 64, 4 + i))
               for i in range(6))
    obs = {"kind": "closed_loop", "trace": r}
    assert stats.fused_roofline_pct(obs, "closed_loop") == \
        pytest.approx(100.0 * want / (6 * 6.3e-3))
    read = harness.load_module(harness.ROOT / "portbench" / "metrics"
                               / "fused_step_roofline.batch.py").read
    assert 45 < read(obs) < 50
    stats.reckon_fused(r, cfg, cell, 4, 7)
    assert read(obs) is None
    stats.reckon_fused(r, cfg, {**cell, "dtype": "float32"}, 4, 6)
    assert read(obs) is None


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

