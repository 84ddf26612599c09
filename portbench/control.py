"""Readings for the limits of `correct`: the program's numbers and its
control's, on many seeds in one process, at the cell's own size and load
with a short window.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        --seconds 8

The control is the nearest precision below the one the configuration
states, in the program's place. A cell names it under "control":

  * {"policy": {...}}: the reference with that quantization policy (int4
    where the cell serves int8), run once over the same prompts and served
    tokens; at each position the token it puts first is read against the
    cell's reference;
  * {"overrides": {...}}: the program's own lower-precision path (the
    cell's keys changed, e.g. quant "auto"), run on the same seed and read
    like the program.

The weights and the reference are the configuration's model type's
(`portbench/models/<model_type>.py`, found by `harness.model_of`), so a
model of any type reads its control the same way.

One JSON line a seed: {seed, program: numbers, control: numbers}.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness
from portbench.reference import check


def served_run(ctx) -> tuple:
    """The window, its sample, and the program freed: (obs, sample)."""
    kind = harness.kind_of(ctx)
    prog = kind.setup(ctx)
    obs = kind.window(ctx, prog)
    smp = kind.sample(ctx, prog, obs)
    kind.teardown(prog)
    del prog
    harness.free_device()
    return obs, smp


def readings(workload: str, seed: int, seconds: float, device: str) -> dict:
    import torch
    ctx = harness.context(workload, seed, seconds, False, device=device)
    cfg, cell = ctx.config, ctx.cell
    model = harness.model_of(ctx)
    obs, smp = served_run(ctx)
    w = model.make(cfg, seed, device, getattr(torch, cell["dtype"]))
    ok = check.allowed_mask(cfg["vocab_size"], smp["banned_ids"],
                            smp["banned_from"], device)
    refs = model.served_logits(w, cfg, smp["audio"], smp["prompts"],
                               smp["served"], cell.get("policy", {}), device)
    out = {"seed": seed, "counts": obs.get("counts", {}),
           "program": check.served_numbers(refs, smp["served"], ok)}
    ctrl = cell["control"]
    if "policy" in ctrl:
        low = model.served_logits(w, cfg, smp["audio"], smp["prompts"],
                                  smp["served"], ctrl["policy"], device)
        out["control"] = check.control_numbers(refs, low, ok)
    else:
        del w, refs
        harness.free_device()
        ctx2 = harness.context(workload, seed, seconds, False, device=device,
                               overrides={"cell": ctrl["overrides"]})
        _, smp2 = served_run(ctx2)
        w = model.make(cfg, seed, device, getattr(torch, cell["dtype"]))
        refs = model.served_logits(w, cfg, smp2["audio"], smp2["prompts"],
                                   smp2["served"], cell.get("policy", {}),
                                   device)
        out["control"] = check.served_numbers(refs, smp2["served"], ok)
    harness.free_device()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds,
                                  args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
