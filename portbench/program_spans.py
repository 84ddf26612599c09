"""Readings of the program's own spans (`whisper_tpu_torch.utils.profiling`)
for the two cells, and a runner that takes them.

The readers here take an `obs` as the kinds return it, with two more
entries: `obs["program"]`, the tracer's records (`profiling.stop()`) of
the whole window, the tracer started after set-up; and, in a traced run,
`obs["trace"]["program"]`, what `program_trace` computes from the
profiler's capture and those records. Each returns a number, or None when
it finds nothing to read (a program without the spans, the CPU without
device ops).

`portbench.run` does not start the tracer: the kinds would have to start
and stop it around the window and `trace.reduce` take the program's spans,
edits of files this module leaves as they are. Until then
`python3 -m portbench.program_spans --workload <cell> --seed <n>
--seconds <s>` runs a cell's kind as a `--trace 1` run does, with the
tracer on, and prints one JSON line: the readings below,
the cell's existing per-layer metrics over the same window, the idle gaps
named by program spans, and the clock check. It runs no reference check.
That runner (`main`, `run`, `keep_captures`) goes once the kinds start
the tracer; the readers, `attribute` and `program_trace` stay.

Program spans and the profiler's events share one clock (`time.time_ns()`
on both sides), so nothing is mapped. A device op belongs to the span in
which the runtime call that launched it started, matched by the
correlation id kineto gives both; the innermost span that contains an
instant is found from the last span that started before it, up through
its parents (the spans of one thread nest).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys

import numpy as np

from portbench import harness, stats, trace

UNTRACED_MARGIN_NS = 1_000_000_000   # as the host-timed metrics: tracing's
                                     # backlog lasts up to a second past it
LAUNCHES = ("LaunchKernel",)          # cudaLaunchKernel, cuLaunchKernelEx
BLOCKED = "Command Buffer Full"       # a launch waiting for the device's
                                      # queue to drain (CUPTI overhead)


# ---- attribution ---------------------------------------------------------

class Locator:
    """The innermost span containing an instant, among spans that nest."""

    def __init__(self, spans: list):
        self.spans = sorted((sp for sp in spans
                             if sp["end_ns"] > sp["start_ns"]),
                            key=lambda sp: (sp["start_ns"], -sp["end_ns"]))
        self.starts = [sp["start_ns"] for sp in self.spans]
        at = {sp["id"]: i for i, sp in enumerate(self.spans)}
        self.up = [at.get(sp["parent"], -1) for sp in self.spans]

    def find(self, t: int) -> int:
        """Index into self.spans, or -1 outside every span."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i]["end_ns"] < t:
            i = self.up[i]
        return i


def events_of(prof) -> tuple[list, list]:
    """(runtime calls, device ops) of a capture, each (start_ns, end_ns,
    name, correlation id)."""
    calls, ops = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = trace._bounds(e)
        row = (start, end, e.name(), int(e.correlation_id()))
        if trace._is_device(e):
            ops.append(row)
        elif e.device_type().name == "CPU":
            calls.append(row)
    return calls, ops


def _merged(ops: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device's busy intervals (starts, ends) and their running
    total, for busy time inside any interval."""
    busy = trace._union(np.array([o[0] for o in ops], np.int64),
                        np.array([o[1] for o in ops], np.int64),
                        -2 ** 62, 2 ** 62) if ops else []
    s = np.array([a for a, _ in busy], np.int64)
    e = np.array([b for _, b in busy], np.int64)
    return s, e, np.concatenate([[0], np.cumsum(e - s)])


def _busy_ns(merged, lo: int, hi: int) -> int:
    s, e, csum = merged
    if hi <= lo or not len(s):
        return 0
    i = int(np.searchsorted(e, lo, "right"))     # first ending after lo
    j = int(np.searchsorted(s, hi, "left"))      # first starting at/after hi
    if j <= i:
        return 0
    total = int(csum[j] - csum[i])
    total -= max(0, lo - int(s[i]))
    total -= max(0, int(e[j - 1]) - hi)
    return max(0, total)


def attribute(calls: list, ops: list, spans: list) -> dict:
    """{span id: {"device_s", "ops", "busy_s", "blocked_s"}} over the
    spans that hold a launch, overlap device work or block: the device
    seconds and count of the ops whose launching call (same correlation
    id) started inside the span (innermost), the seconds in the span
    during which any op ran, and the seconds of the `BLOCKED` events that
    started inside it (innermost)."""
    loc = Locator(spans)
    out: dict = {}

    def of(i: int) -> dict:
        return out.setdefault(loc.spans[i]["id"], {
            "device_s": 0.0, "ops": 0, "busy_s": 0.0, "blocked_s": 0.0})

    launched = {c[3]: c[0] for c in calls}
    for start, end, _, corr in ops:
        t = launched.get(corr)
        i = loc.find(t) if t is not None else -1
        if i >= 0:
            a = of(i)
            a["device_s"] += (end - start) / 1e9
            a["ops"] += 1
    for start, end, name, _ in calls:
        i = loc.find(start) if BLOCKED in name else -1
        if i >= 0:
            of(i)["blocked_s"] += (end - start) / 1e9
    merged = _merged(ops)
    for i, sp in enumerate(loc.spans):
        b = _busy_ns(merged, sp["start_ns"], sp["end_ns"])
        if b:
            of(i)["busy_s"] = b / 1e9
    return out


def clock_check(calls: list, spans: list, names: tuple, lo_ns: int,
                hi_ns: int) -> dict:
    """How well the two clocks agree, from the kernel launches between the
    first and the last span named in `names` inside [lo_ns, hi_ns]: the
    share that lie whole inside one such span (the driving thread launches
    nothing between them), and the bounds on an offset d (kineto =
    program + d) that every span's first and last launch allow."""
    own = [sp for sp in spans if sp["name"] in names
           and lo_ns <= sp["start_ns"] < sp["end_ns"] <= hi_ns]
    if not own:
        return {}
    loc = Locator(own)
    lo = min(sp["start_ns"] for sp in own)
    hi = max(sp["end_ns"] for sp in own)
    launches = [c for c in calls if any(k in c[2] for k in LAUNCHES)
                and lo <= c[0] <= hi]
    inside, first, last = 0, {}, {}
    for start, end, _, _ in launches:
        i = loc.find(start)
        if i >= 0 and end <= loc.spans[i]["end_ns"]:
            inside += 1
        if i >= 0:
            first[i] = min(first.get(i, start), start)
            last[i] = max(last.get(i, end), end)
    d_hi = min((t - loc.spans[i]["start_ns"] for i, t in first.items()),
               default=None)
    d_lo = min((loc.spans[i]["end_ns"] - t for i, t in last.items()),
               default=None)
    return {"launches": len(launches),
            "inside_pct": 100.0 * inside / len(launches) if launches
            else None,
            "offset_ns_at_most": d_hi,
            "offset_ns_at_least": None if d_lo is None else -d_lo}


def program_trace(prof, lo_ns: int, hi_ns: int, host_spans: list,
                  records: dict) -> dict:
    """What the readers take from a capture: the bounds, each span's
    device work (`attribute`), the idle gaps named by the innermost
    program or benchmark span, and the clock checks of both cells' span
    families."""
    calls, ops = events_of(prof)
    spans = records["spans"]
    named = [(sp["start_ns"], sp["end_ns"], sp["name"]) for sp in spans
             if sp["end_ns"] > sp["start_ns"]]
    gaps = trace.reduce(prof, lo_ns, hi_ns,
                        list(host_spans) + named)["idle_gaps"]
    return {"lo_ns": lo_ns, "hi_ns": hi_ns,
            "spans": attribute(calls, ops, spans), "idle_gaps": gaps,
            "clock": {"decode": clock_check(
                calls, spans, ("decode.step", "decode.poll"), lo_ns, hi_ns),
                "engine": clock_check(calls, spans, ("engine.step",), lo_ns,
                                      hi_ns)}}


# ---- the readers ---------------------------------------------------------

def _spans(obs: dict) -> list:
    return obs.get("program", {}).get("spans", [])


def _capture(obs: dict):
    tr = obs.get("trace")
    return tr.get("program") if tr else None


def _untraced(obs: dict, t_ns: int) -> bool:
    """Inside the window before the traced stretch (less a second)."""
    cap = _capture(obs)
    return cap is None or t_ns < cap["lo_ns"] - UNTRACED_MARGIN_NS


def _traced(obs: dict, sp: dict) -> bool:
    cap = _capture(obs)
    return cap is not None and cap["lo_ns"] <= sp["start_ns"] and \
        sp["end_ns"] <= cap["hi_ns"]


def _children(spans: list) -> dict:
    kids: dict = {}
    for sp in spans:
        kids.setdefault(sp["parent"], []).append(sp)
    return kids


def _ms(sp: dict) -> float:
    return (sp["end_ns"] - sp["start_ns"]) / 1e6


def admit_wait_p95_ms(obs: dict):
    """engine: p95 over requests submitted before the traced stretch of
    fill start - submit (the `admit` events); a request never admitted
    counts until the end of the drain."""
    if obs.get("kind") != "open_loop":
        return None
    admits = [sp for sp in _spans(obs) if sp["name"] == "admit"]
    if not admits:
        return None
    waits = [(a["start_ns"] - a["attrs"]["submit_ns"]) / 1e6 for a in admits
             if _untraced(obs, a["attrs"]["submit_ns"])]
    lo = (None if _capture(obs) is None else
          obs["trace"]["perf_lo"] - UNTRACED_MARGIN_NS / 1e9)
    waits += [1e3 * (obs["t_end"] - r["sent"]) for r in obs["requests"]
              if r["admit"] is None and r["sent"] is not None
              and (lo is None or r["sent"] < lo)]
    return stats.pct(waits, 95)


def fill_encode_ms(obs: dict):
    """engine: device ms of the kernels launched inside `fill.encode`, per
    fill, in the traced stretch."""
    cap = _capture(obs)
    if obs.get("kind") != "open_loop" or cap is None:
        return None
    enc = [sp for sp in _spans(obs) if sp["name"] == "fill.encode"
           and _traced(obs, sp)]
    dev = sum(cap["spans"].get(sp["id"], {}).get("device_s", 0.0)
              for sp in enc)
    return 1e3 * dev / len(enc) if enc and dev > 0 else None


def _busy_pct(cap: dict, spans: list):
    """% of the spans' time in which a device op runs; None without."""
    wall = sum(sp["end_ns"] - sp["start_ns"] for sp in spans) / 1e9
    busy = sum(cap["spans"].get(sp["id"], {}).get("busy_s", 0.0)
               for sp in spans)
    return 100.0 * busy / wall if wall > 0 and busy > 0 else None


def _blocked_ms(cap: dict, spans: list, per: int):
    """ms of `BLOCKED` events inside the spans, over `per`; None where
    none of the spans launched a device op (no device)."""
    got = [cap["spans"].get(sp["id"], {}) for sp in spans]
    if not per or not any(a.get("ops") for a in got):
        return None
    return 1e3 * sum(a.get("blocked_s", 0.0) for a in got) / per


def fill_idle(obs: dict):
    """engine: % of the traced admitting `engine.step` spans' time in which
    no device op runs."""
    cap = _capture(obs)
    if obs.get("kind") != "open_loop" or cap is None:
        return None
    busy = _busy_pct(cap, [sp for sp in _spans(obs)
                           if sp["name"] == "engine.step"
                           and sp["attrs"].get("admitted")
                           and _traced(obs, sp)])
    return None if busy is None else 100.0 - busy


def _token_steps(obs: dict, traced: bool = False) -> tuple[list, dict]:
    """The `engine.step` spans that admit nothing, untraced (or traced),
    and every span's children."""
    spans = _spans(obs)
    return ([sp for sp in spans if sp["name"] == "engine.step"
             and not sp["attrs"].get("admitted")
             and (_traced(obs, sp) if traced
                  else _untraced(obs, sp["start_ns"]))], _children(spans))


def token_issue_ms(obs: dict):
    """engine: median host ms of `engine.token` over the untraced steps
    that admit nothing."""
    if obs.get("kind") != "open_loop":
        return None
    steps, kids = _token_steps(obs)
    v = [_ms(k) for sp in steps for k in kids.get(sp["id"], [])
         if k["name"] == "engine.token"]
    return stats.median(v) if v else None


def sync_wait_ms(obs: dict):
    """engine: median host ms of `sync.read` over the same steps."""
    if obs.get("kind") != "open_loop":
        return None
    steps, kids = _token_steps(obs)
    v = [_ms(r) for sp in steps for s in kids.get(sp["id"], [])
         if s["name"] == "engine.sync" for r in kids.get(s["id"], [])
         if r["name"] == "sync.read"]
    return stats.median(v) if v else None


def token_busy(obs: dict):
    """engine: % of the traced steps that admit nothing during which a
    device op runs (near 100: the device sets the step's pace)."""
    cap = _capture(obs)
    if obs.get("kind") != "open_loop" or cap is None:
        return None
    return _busy_pct(cap, _token_steps(obs, traced=True)[0])


def token_blocked_ms(obs: dict):
    """engine: ms a traced step that admits nothing spends with a launch
    blocked on the device's full queue, per step."""
    cap = _capture(obs)
    if obs.get("kind") != "open_loop" or cap is None:
        return None
    steps, kids = _token_steps(obs, traced=True)
    return _blocked_ms(cap, [k for sp in steps for k in kids.get(sp["id"], [])
                             if k["name"] == "engine.token"], len(steps))


def _batches(obs: dict) -> list:
    """The decode loop's spans grouped by batch: each `decode.prefill`
    opens one. [(prefill, [decode.step], [decode.poll])]"""
    out = []
    for sp in sorted(_spans(obs), key=lambda sp: sp["start_ns"]):
        if sp["name"] == "decode.prefill":
            out.append((sp, [], []))
        elif out and sp["name"] == "decode.step":
            out[-1][1].append(sp)
        elif out and sp["name"] == "decode.poll":
            out[-1][2].append(sp)
    return out


def _per_step_ms(obs: dict, which: int):
    if obs.get("kind") != "closed_loop":
        return None
    v = [sum(_ms(sp) for sp in b[which]) / len(b[1])
         for b in _batches(obs) if b[1] and not _traced(obs, b[0])]
    return stats.median(v) if v else None


def decode_issue_ms(obs: dict):
    """batch: median over untraced batches of (sum of `decode.step`) /
    steps."""
    return _per_step_ms(obs, 1)


def decode_poll_wait_ms(obs: dict):
    """batch: median over untraced batches of (sum of `decode.poll`) /
    steps."""
    return _per_step_ms(obs, 2)


def _loop(obs: dict, names: tuple) -> list:
    """The traced spans of the decode loop named in `names`."""
    return [sp for sp in _spans(obs) if sp["name"] in names
            and _traced(obs, sp)]


def decode_kernels(obs: dict):
    """batch: device ops launched inside `decode.step` spans in the traced
    batch, per step."""
    cap = _capture(obs)
    if obs.get("kind") != "closed_loop" or cap is None:
        return None
    steps = _loop(obs, ("decode.step",))
    ops = sum(cap["spans"].get(sp["id"], {}).get("ops", 0) for sp in steps)
    return ops / len(steps) if steps and ops else None


def decode_busy(obs: dict):
    """batch: % of the traced batch's decode loop (its `decode.step` and
    `decode.poll` spans) during which a device op runs."""
    cap = _capture(obs)
    if obs.get("kind") != "closed_loop" or cap is None:
        return None
    return _busy_pct(cap, _loop(obs, ("decode.step", "decode.poll")))


def decode_blocked_ms(obs: dict):
    """batch: ms a `decode.step` of the traced batch spends with a launch
    blocked on the device's full queue, per step."""
    cap = _capture(obs)
    if obs.get("kind") != "closed_loop" or cap is None:
        return None
    steps = _loop(obs, ("decode.step",))
    return _blocked_ms(cap, steps, len(steps))


READERS = {
    "admit_wait_p95_ms.engine": admit_wait_p95_ms,
    "fill_encode_ms.engine": fill_encode_ms,
    "fill_idle.engine": fill_idle,
    "token_issue_ms.engine": token_issue_ms,
    "sync_wait_ms.engine": sync_wait_ms,
    "decode_issue_ms.batch": decode_issue_ms,
    "decode_poll_wait_ms.batch": decode_poll_wait_ms,
    "decode_kernels.batch": decode_kernels,
    "token_busy.engine": token_busy,
    "token_blocked_ms.engine": token_blocked_ms,
    "decode_busy.batch": decode_busy,
    "decode_blocked_ms.batch": decode_blocked_ms,
}


# ---- the runner ----------------------------------------------------------

@contextlib.contextmanager
def keep_captures(kept: list):
    """While inside, every `trace.Capture` reduced also leaves (profiler,
    lo_ns, hi_ns, host spans in ns) in `kept`, for `program_trace` once
    the window's spans are all closed."""
    real = trace.Capture.reduce

    def reduce(self, host_spans=(), groups=None, launches=None):
        prof = self.prof
        out = real(self, host_spans, groups, launches)
        kept.append((prof, self.lo_ns, self.hi_ns,
                     [(self.to_ns(a), self.to_ns(b), label)
                      for a, b, label in host_spans]))
        return out

    trace.Capture.reduce = reduce
    try:
        yield
    finally:
        trace.Capture.reduce = real


def run(ctx) -> dict:
    """A traced run of the cell's kind, with the program's tracer on from
    the window's start to its end: the obs, with "program" and, where a
    stretch was captured, trace["program"]."""
    from whisper_tpu_torch.utils import profiling
    kind = harness.kind_of(ctx)
    prog = kind.setup(ctx)
    kept: list = []
    with keep_captures(kept):
        profiling.start()
        try:
            obs = kind.window(ctx, prog)
        finally:
            records = profiling.stop()
    kind.teardown(prog)
    obs["program"] = records
    if kept and obs.get("trace") is not None:
        prof, lo, hi, host = kept[0]
        obs["trace"]["program"] = program_trace(prof, lo, hi, host, records)
    kept.clear()
    return obs


def line_of(ctx, obs: dict) -> dict:
    """The runner's JSON line for one run of a cell."""
    import torch
    spans = _spans(obs)
    cap = _capture(obs) or {}
    counts: dict = {}
    buckets: dict = {}
    blocked: dict = {}
    for sp in spans:
        name = sp["name"]
        counts[name] = counts.get(name, 0) + 1
        if name == "engine.fill":
            b = sp["attrs"]["bucket"]
            buckets[b] = buckets.get(b, 0) + 1
        ms = 1e3 * cap.get("spans", {}).get(sp["id"], {}).get("blocked_s", 0)
        if ms:
            blocked[name] = blocked.get(name, 0.0) + ms
    return {"workload": ctx.name, "seed": ctx.seed,
            "device": (torch.cuda.get_device_name(0)
                       if ctx.device == "cuda" else "cpu"),
            "program_metrics": {name: fn(obs)
                                for name, fn in READERS.items()},
            "metrics": {k: v["value"]
                        for k, v in harness.read_metrics(ctx, obs).items()},
            "span_counts": counts, "fill_buckets": buckets,
            "blocked_ms_by_span": blocked,
            "clock": cap.get("clock"),
            "idle_gaps_program": cap.get("idle_gaps"),
            "idle_gaps_benchmark": (obs.get("trace") or {}).get("idle_gaps")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = harness.context(args.workload, args.seed, args.seconds, True)
    obs = run(ctx)
    for text in ctx.notes:
        print(text, file=sys.stderr)
    print(json.dumps(line_of(ctx, obs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
