"""The knee sweep of an open-loop cell: the highest arrival rate at which
the engine keeps up, found once on the chip so that the cell's rate can
be fixed as a number in its file (about 0.8 of the knee).

    python3 -m portbench.sweep --workload turbo.engine32 \
        --seeds <n1>,<n2>,<n3> --seconds 51 --rates 2.25,2.5,2.75,3

One process builds the program once, from the first seed, and runs the
cell's schedule at each rate in turn, once for each seed's schedule (the
order of its arrivals and prompts), under the cell's own rules: its
`drain_s`. A window keeps up when no request is refused, every request
due completes within the drain, and the queue does not grow: its mean
depth over the window's last quarter is at most its mean over the
second quarter plus one. A rate is sustained when every seed's window
keeps up, since each run of the cell draws a new seed. The knee is the
highest rate that is sustained with every lower rate, so the sweep stops
at the first rate that is not. One JSON line a window, then the knee.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def summary(obs: dict) -> dict:
    from portbench import stats
    seconds = obs["seconds"]
    q = [np.mean([d for t, d in obs["depth"]
                  if k * seconds / 4 <= t < (k + 1) * seconds / 4] or [0])
         for k in range(4)]
    reqs = obs["requests"]
    refused = sum(r["refused"] for r in reqs)
    unfinished = sum(1 for r in reqs if not r["refused"] and r["ids"] is None)
    fills = stats.step_walls(obs, fills=True)
    steps = stats.step_walls(obs, fills=False)
    admitted = [n for _, _, n in obs["steps"] if n > 0]
    g = stats.gaps(obs)
    fill_gaps = sum(1 for x in g if x > 0.1)
    return {"rate": obs["rate"], "requests": len(reqs), "refused": refused,
            "unfinished": unfinished, "drain_s": obs["drain_s"],
            "depth_by_quarter": [float(x) for x in q],
            "ttft_p50_ms": 1e3 * stats.pct([r["ttft"] for r in reqs], 50),
            "ttft_p95_ms": 1e3 * stats.pct([r["ttft"] for r in reqs], 95),
            "gap_p50_ms": 1e3 * stats.pct(g, 50) if g else None,
            "gap_p95_ms": 1e3 * stats.pct(g, 95) if g else None,
            "gaps_over_100ms_share": fill_gaps / max(1, len(g)),
            "fills": len(fills), "rows_a_fill": float(np.mean(admitted))
            if admitted else 0.0,
            "fill_ms_p50": 1e3 * stats.median(fills) if fills else None,
            "step_ms_p50": 1e3 * stats.median(steps) if steps else None,
            "sustained": bool(refused == 0 and unfinished == 0
                              and q[3] <= q[1] + 1.0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import harness
    seeds = [int(x) for x in args.seeds.split(",")]
    ctx = harness.context(args.workload, seeds[0], args.seconds, False,
                          device=args.device)
    kind = harness.kind_of(ctx)
    t = time.perf_counter()
    prog = kind.setup(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    knee = None
    for rate in (float(x) for x in args.rates.split(",")):
        kept_up = True
        for seed in seeds:
            s = summary(kind.window(dataclasses.replace(ctx, seed=seed),
                                    prog, rate=rate, seconds=args.seconds))
            print(json.dumps({"seed": seed, **s}), flush=True)
            kept_up = kept_up and s["sustained"]
        if not kept_up:
            break
        knee = rate
    print(json.dumps({"knee": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
