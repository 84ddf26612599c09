"""Statistics the metric readers share. A percentile is numpy's linear
interpolation over every sample (no sample is dropped, none summarised
first); a roofline share is the least time the chip could take over the
device time measured, and is None when nothing was measured. A kernel's
least time is reckoned call by call from what the trace says that call
computed (`reckon_tail`, `reckon_fused`, run by the kinds once the trace
is reduced), never from the cell's slot or batch count."""

from __future__ import annotations

import collections
import math

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


def reckon_tail(tr: dict, cfg: dict, cell: dict) -> None:
    """Each traced tail call's windows, from its row-tiled launch's grid
    (the cell's `tail_grid`: that kernel and its rows a block), and its
    least time at them (`costs.tail_work`, int8 under the cell's encoder
    policy); None for both where the grid cannot be read."""
    grid = cell["tail_grid"]
    int8 = bool(cell.get("policy", {}).get("enc_bits"))
    for call in tr["groups"]["tail"]["per_call"]:
        g = call["grid"]
        w = (costs.windows_of(g[1], grid["rows_per_block"],
                              cfg["max_source_positions"])
             if g is not None else None)
        call["windows"] = w
        call["bound_s"] = (costs.bound_s(costs.tail_work(cfg, w, int8))
                           if w is not None else None)


def tail_roofline_pct(obs: dict, kind: str):
    """The sum over the traced tail calls of each call's least time at
    the windows it computed, over the device time of the tail's kernels,
    in the traced stretch; None where a call's windows were not read."""
    tr = trace_of(obs, kind)
    if tr is None:
        return None
    g = tr["groups"].get("tail", {})
    calls = g.get("per_call", [])
    if not calls or g.get("device_s", 0.0) <= 0 or \
            any(c.get("bound_s") is None for c in calls):
        return None
    return 100.0 * math.fsum(c["bound_s"] for c in calls) / g["device_s"]


def reckon_fused(tr: dict, cfg: dict, cell: dict, prompt_len: int,
                 steps: int) -> None:
    """The traced batch's fused decoder step launches (the cell's
    `fused_kernel`) and their least time: the greedy loop's step i runs
    over the batch's rows with prompt_len + i self positions cached
    (`decode._greedy_loop`: step(last, P + i)), and no row ends early, so
    launch i is reckoned at those. None where the launches are not the
    loop's `steps` or the cell does not run in bf16 (the count's dtype)."""
    times = tr["launches"].get("fused_step", [])
    bound = None
    if times and len(times) == steps and cell["dtype"] == "bfloat16":
        bound = math.fsum(costs.bound_s(costs.fused_step_work(
            cfg, cell["batch"], prompt_len + i)) for i in range(steps))
    tr["fused_step"] = {"launches": len(times), "device_s": sum(times),
                        "bound_s": bound}


def kernels_note(tr: dict) -> str:
    """A line for standard error: the traced tail calls by the windows
    each encoded (None: not read), and the fused step's launches."""
    by = collections.Counter(c["windows"]
                             for c in tr["groups"]["tail"]["per_call"])
    text = ("traced tail calls by windows encoded "
            f"{dict(sorted(by.items(), key=str))}")
    f = tr.get("fused_step")
    if f is not None:
        text += (f"; fused step launches {f['launches']} in "
                 f"{f['device_s']!r} s, least {f['bound_s']!r} s")
    return text


def fused_roofline_pct(obs: dict, kind: str):
    """The fused step's least time over its launches' device time."""
    tr = trace_of(obs, kind)
    f = tr.get("fused_step") if tr is not None else None
    if f is None or f["bound_s"] is None or f["device_s"] <= 0:
        return None
    return 100.0 * f["bound_s"] / f["device_s"]


def mfu_pct(flops: float, seconds: float):
    if seconds is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / costs.PEAK_BF16
