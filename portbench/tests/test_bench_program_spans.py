"""The readings of the program's spans (`portbench/program_spans.py`): each
reader computed by hand from a synthetic obs, device ops attributed to
spans by correlation id, idle gaps named by the innermost program span,
and a traced CPU run of each cell at tiny's width."""

from __future__ import annotations

import types

import pytest

from portbench import harness, program_spans as ps
from portbench.tests.conftest import tiny_overrides

MS = 1_000_000          # ns


def sp(i, name, start, end, parent=0, **attrs):
    return {"id": i, "name": name, "parent": parent, "start_ns": start, "end_ns": end, "attrs": attrs}


class Ev:
    """A kineto-like event: what trace.reduce and events_of read."""

    def __init__(self, start, end, name, corr, device="CPU",
                 activity="cuda_runtime"):
        self._s, self._e, self._n, self._c = start, end, name, corr
        self._d, self._a = device, activity

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def device_type(self):
        return types.SimpleNamespace(name=self._d)

    def activity_type(self):
        return self._a


def prof_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def kernel(start, end, corr, name="k"):
    return Ev(start, end, name, corr, device="CUDA", activity="kernel")


def test_locator_finds_the_innermost_span():
    spans = [sp(1, "a", 0, 100), sp(2, "b", 10, 50, 1), sp(3, "c", 20, 30, 2),
             sp(4, "d", 60, 70, 1), sp(5, "e", 200, 300)]
    loc = ps.Locator(spans)
    name = {t: (loc.spans[loc.find(t)]["name"] if loc.find(t) >= 0
                else None)
            for t in (5, 15, 25, 40, 55, 65, 99, 150, 250, 301)}
    assert name == {5: "a", 15: "b", 25: "c", 40: "b", 55: "a", 65: "d",
                    99: "a", 150: None, 250: "e", 301: None}


def test_attribution_by_correlation_id():
    """A kernel belongs to the span in which its launch started, even when
    it runs after that span has ended; a launch outside every span leaves
    its kernel to none; a launch blocked on the full queue counts to the
    innermost span in which the block started."""
    spans = [sp(1, "engine.step", 0, 100), sp(2, "fill.encode", 10, 40, 1),
             sp(3, "engine.token", 60, 80, 1)]
    calls = [(12, 14, "cudaLaunchKernel", 7), (62, 63, "cuLaunchKernelEx", 8),
             (150, 151, "cudaLaunchKernel", 9), (41, 42, "cudaMemcpyAsync", 6),
             (64, 70, "Command Buffer Full", 0),
             (72, 75, "Command Buffer Full", 0),
             (160, 190, "Command Buffer Full", 0)]
    ops = [(50, 90, "enc", 7),        # after fill.encode ended, in token's
           (90, 120, "tok", 8),       # past its step's end
           (160, 170, "late", 9),     # launched outside every span
           (45, 48, "copy", 6)]       # launched in the step, between parts
    got = ps.attribute(calls, ops, spans)
    assert got[2]["ops"] == 1 and got[2]["device_s"] == pytest.approx(40e-9)
    assert got[3]["ops"] == 1 and got[3]["device_s"] == pytest.approx(30e-9)
    assert got[1]["ops"] == 1 and got[1]["device_s"] == pytest.approx(3e-9)
    # busy: the step [0, 100] holds 45-48 and 50-100; encode [10, 40] none
    assert got[1]["busy_s"] == pytest.approx(53e-9)
    assert got[2]["busy_s"] == 0.0
    assert got[3]["busy_s"] == pytest.approx(20e-9)
    assert got[3]["blocked_s"] == pytest.approx(9e-9)
    assert got[1]["blocked_s"] == got[2]["blocked_s"] == 0.0


def test_clock_check_bounds_the_offset():
    spans = [sp(1, "decode.step", 100, 200), sp(2, "decode.poll", 210, 230),
             sp(3, "decode.step", 240, 400)]
    calls = [(110, 115, "cudaLaunchKernel", 1), (190, 196, "cudaLaunchKernel", 2),
             (215, 220, "cuLaunchKernelEx", 3), (250, 260, "cudaLaunchKernel", 4),
             (236, 238, "cudaLaunchKernel", 5),      # between two spans
             (50, 60, "cudaLaunchKernel", 6)]        # before the loop
    got = ps.clock_check(calls, spans, ("decode.step", "decode.poll"), 0,
                         1000)
    assert got["launches"] == 5
    assert got["inside_pct"] == pytest.approx(80.0)
    assert got["offset_ns_at_most"] == 5          # the poll's first launch
    assert got["offset_ns_at_least"] == -4        # step 1's last ends at 196


def test_the_innermost_program_span_names_a_gap_ahead_of_step_fill():
    """An idle gap inside the fill's audio copy is named by fill.audio and
    the runtime call in flight, not by the benchmark's step.fill."""
    spans = [sp(1, "engine.step", 0, 100 * MS), sp(2, "engine.fill", 1 * MS,
                                                    90 * MS, 1),
             sp(3, "fill.audio", 2 * MS, 30 * MS, 2),
             sp(4, "fill.encode", 31 * MS, 80 * MS, 2)]
    events = [Ev(2 * MS + MS // 2, 29 * MS, "cudaMemcpyAsync", 1),
              kernel(0, 3 * MS, 2), kernel(29 * MS, 95 * MS, 1),
              kernel(95 * MS, 100 * MS, 3)]
    out = ps.program_trace(prof_of(events), 0, 100 * MS,
                           [(0, 100 * MS, "step.fill")], {"spans": spans})
    label, seconds = out["idle_gaps"][0]
    assert label == "fill.audio > cudaMemcpyAsync"
    assert seconds == pytest.approx(26e-3)
    assert out["spans"][3]["ops"] == 1


def _engine_obs(capture: bool) -> dict:
    """Two untraced token steps and a fill, then a traced stretch from
    10 s with one admitting step; two requests submitted before it were
    admitted, one was refused."""
    s = 1_000 * MS
    spans = [
        sp(1, "engine.step", 1 * s, 1 * s + 20 * MS, admitted=0),
        sp(2, "engine.token", 1 * s + 1 * MS, 1 * s + 11 * MS, 1),
        sp(3, "engine.sync", 1 * s + 12 * MS, 1 * s + 19 * MS, 1),
        sp(4, "sync.read", 1 * s + 13 * MS, 1 * s + 15 * MS, 3),
        sp(5, "engine.step", 2 * s, 2 * s + 30 * MS, admitted=0),
        sp(6, "engine.token", 2 * s + 1 * MS, 2 * s + 15 * MS, 5),
        sp(7, "engine.sync", 2 * s + 16 * MS, 2 * s + 29 * MS, 5),
        sp(8, "sync.read", 2 * s + 17 * MS, 2 * s + 21 * MS, 7),
        sp(9, "engine.step", 3 * s, 3 * s + 600 * MS, admitted=2),
        sp(10, "engine.fill", 3 * s + 1 * MS, 3 * s + 500 * MS, 9),
        sp(11, "admit", 3 * s + 1 * MS, 3 * s + 1 * MS, 10, rid=0,
           submit_ns=3 * s - 400 * MS),
        sp(12, "admit", 3 * s + 1 * MS, 3 * s + 1 * MS, 10, rid=1,
           submit_ns=3 * s - 100 * MS),
        sp(13, "fill.encode", 3 * s + 50 * MS, 3 * s + 60 * MS, 10),
        sp(14, "engine.step", 10 * s, 10 * s + 500 * MS, admitted=1),
        sp(15, "engine.fill", 10 * s, 10 * s + 400 * MS, 14),
        sp(16, "fill.encode", 10 * s + 10 * MS, 10 * s + 20 * MS, 15),
        sp(17, "admit", 10 * s, 10 * s, 15, rid=2, submit_ns=9 * s),
        sp(18, "engine.step", 11 * s, 11 * s + 20 * MS, admitted=0),
        sp(19, "engine.token", 11 * s + 1 * MS, 11 * s + 13 * MS, 18),
    ]
    obs = {"kind": "open_loop", "t_end": 20.0,
           "requests": [{"admit": 3.0, "sent": 2.6},
                        {"admit": 3.0, "sent": 2.9},
                        {"admit": None, "sent": 5.0},
                        {"admit": 10.0, "sent": 9.0}],
           "program": {"spans": spans}}
    if capture:
        obs["trace"] = {"perf_lo": 9.5, "program": {
            "lo_ns": 9 * s + 500 * MS, "hi_ns": 12 * s,
            "spans": {16: {"device_s": 0.25, "ops": 40, "busy_s": 0.01},
                      14: {"device_s": 0.0, "ops": 0, "busy_s": 0.4},
                      18: {"device_s": 0.0, "ops": 0, "busy_s": 0.015},
                      19: {"device_s": 0.012, "ops": 300, "busy_s": 0.008,
                           "blocked_s": 0.004}}}}
    return obs


def test_engine_readers_by_hand():
    obs = _engine_obs(capture=True)
    # waits of requests submitted before 8.5 s: 401, 101 ms admitted, the
    # refused one (sent 5.0 s) until the drain's end at 20 s: 15,000 ms
    assert ps.admit_wait_p95_ms(obs) == pytest.approx(
        401 + 0.9 * (15_000 - 401))
    assert ps.fill_encode_ms(obs) == pytest.approx(250.0)
    assert ps.fill_idle(obs) == pytest.approx(100 * (1 - 0.4 / 0.5))
    assert ps.token_issue_ms(obs) == pytest.approx(12.0)     # 10, 14
    assert ps.sync_wait_ms(obs) == pytest.approx(3.0)        # 2, 4
    # the traced step that admits nothing: busy 15 of its 20 ms, its
    # token issue blocked 4 ms
    assert ps.token_busy(obs) == pytest.approx(75.0)
    assert ps.token_blocked_ms(obs) == pytest.approx(4.0)
    for fn in (ps.decode_issue_ms, ps.decode_poll_wait_ms,
               ps.decode_kernels, ps.decode_busy, ps.decode_blocked_ms):
        assert fn(obs) is None


def test_engine_readers_without_a_capture():
    obs = _engine_obs(capture=False)
    assert ps.token_issue_ms(obs) == pytest.approx(12.0)     # 10, 14, 12
    assert ps.fill_encode_ms(obs) is None and ps.fill_idle(obs) is None
    assert ps.token_busy(obs) is None and ps.token_blocked_ms(obs) is None
    waits = sorted([401.0, 101.0, 1_000.0, 15_000.0])
    assert ps.admit_wait_p95_ms(obs) == pytest.approx(
        waits[2] + 0.85 * (waits[3] - waits[2]))


def _batch_obs() -> dict:
    """Three batches; the second is traced: steps of 40, 50 ms and polls."""
    s = 1_000 * MS
    spans, i = [], 0
    for b, (step_ms, poll_ms) in enumerate(((40, 2), (90, 9), (50, 4))):
        t = (b + 1) * 10 * s
        i += 1
        spans.append(sp(i, "decode.prefill", t, t + 100 * MS))
        t += 100 * MS
        for k in range(4):
            if k % 2 == 0:
                i += 1
                spans.append(sp(i, "decode.poll", t, t + poll_ms * MS))
                t += poll_ms * MS
            i += 1
            spans.append(sp(i, "decode.step", t, t + step_ms * MS))
            t += step_ms * MS
    traced = [x["id"] for x in spans
              if x["name"] == "decode.step" and 20 * s <= x["start_ns"]
              < 30 * s]
    return {"kind": "closed_loop", "program": {"spans": spans},
            "trace": {"program": {
                "lo_ns": 20 * s - 1, "hi_ns": 29 * s,
                "spans": {j: {"device_s": 0.03, "ops": 1400 + n,
                              "busy_s": 0.045, "blocked_s": 0.01}
                          for n, j in enumerate(traced)}}}}


def test_batch_readers_by_hand():
    obs = _batch_obs()
    # untraced batches: 4 steps of 40 ms with 2 polls of 2 ms, and of 50
    # with 2 of 4; per step 40, 50 (median 45) and 1, 2 (median 1.5)
    assert ps.decode_issue_ms(obs) == pytest.approx(45.0)
    assert ps.decode_poll_wait_ms(obs) == pytest.approx(1.5)
    assert ps.decode_kernels(obs) == pytest.approx(1401.5)
    # the traced batch: 4 steps of 90 ms busy 45 each, 2 polls of 9 ms
    # with no device op; each step blocked 10 ms
    assert ps.decode_busy(obs) == pytest.approx(100 * 0.18 / 0.378)
    assert ps.decode_blocked_ms(obs) == pytest.approx(10.0)
    for fn in (ps.admit_wait_p95_ms, ps.fill_encode_ms, ps.fill_idle,
               ps.token_issue_ms, ps.sync_wait_ms, ps.token_busy,
               ps.token_blocked_ms):
        assert fn(obs) is None


@pytest.mark.parametrize("obs", [
    {"kind": "open_loop", "requests": [], "t_end": 1.0},
    {"kind": "closed_loop", "batches": []},
    {"kind": "open_loop", "requests": [], "t_end": 1.0,
     "program": {"spans": []},
     "trace": {"perf_lo": 0.5}},
])
def test_readers_find_nothing_in_a_program_without_spans(obs):
    """The parent's program has no spans: every reader returns None."""
    assert all(fn(obs) is None for fn in ps.READERS.values())


PROGRAM_SPAN = {"turbo.engine32": ("admit_wait_p95_ms.engine",
                                   "token_issue_ms.engine",
                                   "sync_wait_ms.engine"),
                "medium.batch64": ("decode_issue_ms.batch",
                                   "decode_poll_wait_ms.batch")}
DEVICE_TRACE = ("fill_encode_ms.engine", "fill_idle.engine",
                "decode_kernels.batch", "token_busy.engine",
                "token_blocked_ms.engine", "decode_busy.batch",
                "decode_blocked_ms.batch")


@pytest.fixture
def two_threads():
    """Two intra-op threads, as the repo's CPU tests run the port: eight on
    a shared host that other work loads stall each other for seconds, and
    the open loop's window then closes before any step admits nothing."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,seconds,cell,traffic", [
    ("turbo.engine32", 10.0, {"trace": {"at_s": 8.5, "length_s": 0.5},
                              "rate": 0.5, "drain_s": 2}, {}),
    ("medium.batch64", 1.0, {"trace": {"batch": 1}}, {"max_new": 9}),
])
def test_a_traced_cpu_run_reports_the_program_span_readings(
        workload, seconds, cell, traffic, two_threads):
    """At tiny's width on the CPU: every program_span reading of the cell
    is a number, every device_trace one None (no device ops), the existing
    per-layer metrics still read, and the tracer is off afterwards."""
    from whisper_tpu_torch.utils import profiling
    ov = tiny_overrides(workload, **cell)
    ov["traffic"].update(traffic)
    ctx = harness.context(workload, 2 ** 31 + 91, seconds, True,
                          device="cpu", overrides=ov)
    obs = ps.run(ctx)
    assert not profiling.tracing()
    line = ps.line_of(ctx, obs)
    got = line["program_metrics"]
    for name in PROGRAM_SPAN[workload]:
        assert got[name] is not None and got[name] > 0, (name, got)
    for name in DEVICE_TRACE:
        assert got[name] is None
    other = [n for names in PROGRAM_SPAN.values() for n in names
             if n not in PROGRAM_SPAN[workload]]
    assert all(got[n] is None for n in other)
    assert line["metrics"]
    assert bool(line["fill_buckets"]) == (workload == "turbo.engine32")
    assert line["blocked_ms_by_span"] == {}
