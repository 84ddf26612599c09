"""Reduction of a `torch.profiler` capture to what the per-layer metrics
read: the traced window, the seconds in which an operation ran on the
device, device time by kernel name, the device time of a named group of
kernels call by call (with the launch grid that says what a call
computed), each launch's time of a named kernel, and the longest idle gaps
named by what the host was doing.

The capture records CUDA activity only (kernels, copies, sets and the
runtime and driver calls that issued them), not the host's torch ops:
per-op host recording slows a host-bound step by a large share and would
inflate the very idle share it measures. The host side of a gap is named
from the benchmark's own spans (recorded by the kinds with the host
clock) and the runtime call in flight at the gap's start.

It reads the raw kineto events (`prof.profiler.kineto_results.events()`)
and not `key_averages()`, which would build a Python object per event.
A device operation is any event on the CUDA device that is not an
annotation.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import numpy as np


def _activity(e) -> str:
    """The event's kineto activity type where this torch has the method
    ("kernel", "gpu_memcpy", "cuda_runtime", ...), else ""."""
    fn = getattr(e, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _bounds(e) -> tuple[int, int]:
    """(start, end) in ns, from whichever accessors this torch has."""
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else \
            start + e.duration_ns()
        return start, end
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def _grids(prof, kernels: set) -> dict:
    """The launch grids (x, y, z) of the kernels whose names hold one of
    `kernels`, by correlation id. kineto keeps CUPTI's kernel record
    (grid, block, registers) only in the chrome trace it writes; the
    events it hands back in process carry none of it. So the capture's
    trace is written to a temporary file under TMPDIR, read and removed;
    {} where the profiler writes none."""
    export = getattr(prof, "export_chrome_trace", None)
    if not kernels or export is None:
        return {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        export(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for ev in events:
        args = ev.get("args") or {}
        if "grid" in args and "correlation" in args and \
                any(k in ev.get("name", "") for k in kernels):
            out[args["correlation"]] = tuple(int(g) for g in args["grid"])
    return out


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA" and \
        "annotation" not in _activity(e)


def _union(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int
           ) -> list[tuple[int, int]]:
    """Merged intervals of [starts, ends) clipped to [lo, hi)."""
    order = np.argsort(starts, kind="stable")
    merged: list[list[int]] = []
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(a, b) for a, b in merged]


def group_time(ops: list, own: tuple, lead: tuple,
               grid_of: str | None = None) -> dict:
    """The device seconds and the calls of one program call that launches
    a fixed sequence of kernels: every op whose name holds one of `own`,
    and each op whose name holds one of `lead` when the op after it on
    the device is one of `own` (the same lead kernel launched elsewhere
    is followed by other work); a call runs from its lead to the next.
    `per_call` lists each call's device seconds and, where `grid_of` names
    one of its kernels, the launch grid of the call's first op whose name
    holds it (None where the trace does not carry it). ops: (start, end,
    name, grid or None) by start."""
    total, per_call = 0.0, []
    for i, (s, e, name, grid) in enumerate(ops):
        if any(k in name for k in own):
            total += (e - s) / 1e9
            if per_call:
                call = per_call[-1]
                call["device_s"] += (e - s) / 1e9
                if grid_of is not None and grid_of in name and \
                        "grid" not in call:
                    call["grid"] = grid
        elif any(k in name for k in lead) and i + 1 < len(ops) and \
                any(k in ops[i + 1][2] for k in own):
            total += (e - s) / 1e9
            per_call.append({"device_s": (e - s) / 1e9})
    for call in per_call:
        call.setdefault("grid", None)
    return {"device_s": total, "calls": len(per_call), "per_call": per_call}


def launch_times(ops: list, name: str) -> list[float]:
    """The device seconds of each launch of the kernel whose name holds
    `name`, in launch order."""
    return [(e - s) / 1e9 for s, e, n, _ in ops if name in n]


def reduce(prof, lo_ns: int, hi_ns: int, host_spans: list = (),
           groups: dict | None = None, launches: dict | None = None,
           top: int = 10) -> dict:
    """Summary of the capture over the host window [lo_ns, hi_ns) (epoch
    ns, the profiler's clock): window_s, busy_s, the `top` device ops by
    time, each of `groups` ({name: (own, lead[, grid_of])}) by
    `group_time`, each of `launches` ({name: kernel}) by `launch_times`,
    and the `top` longest idle gaps as [what the host was doing, seconds],
    from `host_spans` [(start_ns, end_ns, label)] and the runtime calls."""
    want = {spec[2] for spec in (groups or {}).values() if len(spec) > 2}
    grids = _grids(prof, want)
    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _bounds(e)
        if _is_device(e):
            name = e.name()
            grid = (grids.get(e.correlation_id())
                    if any(k in name for k in want) else None)
            ops.append((start, end, name, grid))
        elif e.device_type().name == "CPU":
            calls.append((start, end, e.name()))
    ops.sort(key=lambda o: o[:3])
    ds = np.array([o[0] for o in ops], np.int64)
    de = np.array([o[1] for o in ops], np.int64)
    busy = _union(ds, de, lo_ns, hi_ns)
    busy_ns = sum(b - a for a, b in busy)

    by_name: dict[str, float] = collections.defaultdict(float)
    for s, e, n, _ in ops:
        by_name[n] += (e - s) / 1e9

    gaps = []
    edges = [lo_ns] + [x for iv in busy for x in iv] + [hi_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)
    cs = np.array([c[0] for c in calls], np.int64)
    ce = np.array([c[1] for c in calls], np.int64)
    named = []
    for length, at in gaps[:top]:
        inside = [sp for sp in host_spans if sp[0] <= at < sp[1]]
        label = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
                 else "outside spans")
        live = np.nonzero((cs <= at) & (ce > at))[0]
        if len(live):
            label += " > " + calls[int(live[-1])][2]
        named.append([label[:120], length / 1e9])
    ops_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (hi_ns - lo_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": [[n[:120], s] for n, s in ops_top],
            "idle_gaps": named, "device_op_count": len(ops),
            "groups": {g: group_time(ops, tuple(spec[0]), tuple(spec[1]),
                                     *spec[2:])
                       for g, spec in (groups or {}).items()},
            "launches": {k: launch_times(ops, n)
                         for k, n in (launches or {}).items()}}


class Capture:
    """A `torch.profiler` capture (CUDA activity; CPU without a card, for
    the tests) of one stretch of a window, started and stopped between the
    window's steps, each end after a device sync, with its bounds on both
    clocks (the profiler's epoch ns and perf_counter)."""

    def __init__(self):
        self.prof = None
        self.done = False

    @staticmethod
    def prime() -> None:
        """Start and stop one empty capture: the profiler's first start
        initialises CUPTI for seconds, which belongs in set-up."""
        c = Capture()
        c.start()
        c.stop()

    def at(self, elapsed: float, start_s: float, length_s: float) -> None:
        """Start once `elapsed` (s into the window) reaches start_s; stop
        once the capture has run length_s."""
        if self.prof is None and not self.done and elapsed >= start_s:
            self.start()
        elif self.prof is not None and not self.done and \
                time.perf_counter() - self.lo_perf >= length_s:
            self.stop()

    def start(self) -> None:
        import torch
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[
            act.CUDA if torch.cuda.is_available() else act.CPU])
        self.prof.start()
        _sync()
        self.lo_ns, self.lo_perf = time.time_ns(), time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        _sync()
        self.hi_ns, self.hi_perf = time.time_ns(), time.perf_counter()
        self.prof.stop()
        self.done = True

    def to_ns(self, t_perf: float) -> int:
        """A perf_counter time on the profiler's clock."""
        return self.lo_ns + int((t_perf - self.lo_perf) * 1e9)

    def reduce(self, host_spans: list = (), groups: dict | None = None,
               launches: dict | None = None) -> dict:
        """`reduce` over this capture; host_spans in perf_counter s."""
        spans = [(self.to_ns(a), self.to_ns(b), label)
                 for a, b, label in host_spans
                 if b >= self.lo_perf and a <= self.hi_perf]
        out = reduce(self.prof, self.lo_ns, self.hi_ns, spans, groups,
                     launches)
        out["perf_lo"], out["perf_hi"] = self.lo_perf, self.hi_perf
        self.prof = None
        return out


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
