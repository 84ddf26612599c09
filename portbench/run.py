"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (correct, attempted, failed, metrics, device[, breakdown],
checks); the last lines of standard error are the numbers compared,
each beside its limit. Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (from /proc), so that set-up
    counts the interpreter's own start too; 0 where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_START = _T0 - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    ctx = harness.context(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    need = int(ctx.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run(ctx, _T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for text in ctx.notes:
        print(text, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {harness.fmt(c['value'])} limit "
              f"{harness.fmt(c['limit'])}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
