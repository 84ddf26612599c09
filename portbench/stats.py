"""Statistics the metric readers share. A percentile is numpy's linear
interpolation over every sample (no sample is dropped, none summarised
first); a roofline share is the least time the chip could take over the
device time measured, and is None when nothing was measured."""

from __future__ import annotations

import numpy as np

from portbench import costs


def pct(values, q: float):
    values = list(values)
    return float(np.percentile(values, q)) if values else None


def median(values):
    return pct(values, 50)


def gaps(obs: dict) -> list:
    """Every gap between consecutive tokens of every request."""
    return [b - a for r in obs["requests"]
            for a, b in zip(r["toks"], r["toks"][1:])]


def untraced(obs: dict, t: float) -> bool:
    """Whether host time t lies in the part of the window the host-timed
    layer metrics read (before the traced stretch; all of it in an
    untraced run)."""
    return any(a <= t < b for a, b in obs.get(
        "untraced", [(float("-inf"), float("inf"))]))


def untraced_s(obs: dict) -> float:
    return sum(max(0.0, b - a) for a, b in obs["untraced"])


def step_walls(obs: dict, fills: bool) -> list:
    """Host walls of the engine's untraced step() calls that admitted
    requests (fills) or did not."""
    return [te - ts for ts, te, n in obs["steps"]
            if (n > 0) == fills and untraced(obs, ts)]


def trace_of(obs: dict, kind: str):
    return obs.get("trace") if obs.get("kind") == kind else None


def idle_pct(obs: dict, kind: str, wall_s: float | None = None):
    """The share of `wall_s` (default: the traced window) in which no
    operation ran on the device, from the trace's busy seconds."""
    tr = trace_of(obs, kind)
    wall_s = tr["window_s"] if tr is not None and wall_s is None else wall_s
    if tr is None or not wall_s or wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / wall_s)


def tail_roofline_pct(obs: dict, kind: str):
    """The tail's least time per call times its calls, over the device
    time of its kernels, in the traced stretch."""
    tr = trace_of(obs, kind)
    if tr is None:
        return None
    g = tr["groups"].get("tail", {})
    if not g.get("calls") or g.get("device_s", 0.0) <= 0:
        return None
    return 100.0 * tr["tail_bound_s"] * g["calls"] / g["device_s"]


def mfu_pct(flops: float, seconds: float):
    if seconds is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / costs.PEAK_BF16
