"""Device time of flash attention's fp32 backward kernel on the card, at the
train path's shapes, for the checkout at --tree: tiny B=16's causal self
read (224 queries over 448 slots, kv_len 224), its cross read (224 over
1500) and its encoder read (1500 over 1500), and turbo B=4's encoder read
(H=20). Inputs are drawn on the card from seed 1; out and lse come from
the forward kernel.

    python3 tools/flash_bwd_time.py [--tree DIR] [--iters 10] [--sass]

--tree: the checkout whose whisper_tpu_torch is imported and built
(default: this one), so that two kernels can be timed in one call on one
card. Prints one JSON line: the card's name and power limit, the ptxas
registers and spills of the two tiled passes, with --sass their opcode
counts, and per shape the mean ms of `--iters` back-to-back calls by CUDA
events (after a warm-up) and the largest gradient error against the plain
twin as a share of 1e-5 of its max |g| + 1e-6.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, T, S, H, kv_len, causal)
SHAPES = {"self": (16, 224, 448, 6, 224, True),
          "cross": (16, 224, 1500, 6, 1500, False),
          "encoder": (16, 1500, 1500, 6, 1500, False),
          "encoder_turbo": (4, 1500, 1500, 20, 1500, False)}
PASSES = ("dkdv_kernel", "dq_kernel")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def build_info(build, sass: bool) -> dict:
    """ptxas lines (and SASS opcode counts) of the non-causal passes."""
    so, _, log = build.build()
    info, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = next((p for p in PASSES if p + "ILb0" in line), None)
        elif fn and ("registers" in line or "spill" in line):
            info.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    if sass:
        cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        text = subprocess.run([cuobjdump, "-sass", str(so)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in text.splitlines():
            if "Function : " in line:
                fn = next((p for p in PASSES if p + "ILb0" in line), None)
            elif fn and "/*" in line:
                ops = [t for t in line.split("*/", 1)[-1].split(";")[0]
                       .split() if not t.startswith("@")]
                if ops:
                    counts.setdefault(fn, collections.Counter())[ops[0]] += 1
        for p, c in counts.items():
            info[p + "_sass"] = dict(c.most_common(16))
    return info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.tree))
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 1
    import whisper_tpu_torch
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops import flash_attention as fa
    line = {"package": os.path.dirname(whisper_tpu_torch.__file__),
            "card": card_line(), "build": build_info(_build, opts.sass)}
    for name, (B, T, S, H, kv_len, causal) in SHAPES.items():
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(shape, generator=g).cuda() for shape in
                   ((B, T, H, 64), (B, H, S, 64), (B, H, S, 64)))
        kw = dict(kv_len=kv_len, q_offset=0, causal=causal)
        out, (_, lse) = fa._forward_for_grad(q, k, v, **kw)
        d_out = torch.randn(out.shape, generator=g).cuda()
        got = fa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
        want = fa.flash_attention_backward_plain(q, k, v, out, lse, d_out,
                                                 **kw)
        share = max(float((a.double() - b.double()).abs().max())
                    / (1e-5 * float(b.double().abs().max()) + 1e-6)
                    for a, b in zip(got, want))
        del got, want
        for _ in range(2):
            fa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.iters):
            fa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
        end.record()
        end.synchronize()
        line[name] = {"ms": start.elapsed_time(end) / opts.iters,
                      "err_over_tol": share}
        del q, k, v, out, lse, d_out
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
