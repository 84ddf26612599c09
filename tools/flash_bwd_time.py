"""Device time of the fp32 backward kernels on the card, at the train
path's shapes, for the checkout at --tree. Flash attention's backward:
tiny B=16's causal self read (224 queries over 448 slots, kv_len 224), its
cross read (224 over 1500) and its encoder read (1500 over 1500), and
turbo B=4's encoder read (H=20). With --tail, the encoder tail's backward
(`encoder_block_tail_backward`: its products, passes and attention) at a
tiny B=16 layer and a turbo B=4 layer. Inputs are drawn on the card from
seed 1; the residuals come from the forward kernel.

    python3 tools/flash_bwd_time.py [--tree DIR] [--iters 10] [--sass]
    python3 tools/flash_bwd_time.py --tail [--tree DIR] [--iters 10]

--tree: the checkout whose whisper_tpu_torch is imported and built
(default: this one), so that two kernels can be timed in one call on one
card. Prints one JSON line: the card's name and power limit, the ptxas
registers and spills of the tiled passes, with --sass their opcode
counts, and per shape the mean ms of `--iters` back-to-back calls by CUDA
events (after a warm-up) and the largest gradient error against the plain
twin as a share of 1e-5 of its max |g| + 1e-6. --tail adds, per shape,
a rerun's bit-equality, the bytes the call allocates, and device ms per
call by kernel under torch.profiler (three calls), summed into the
products, the passes and the attention.
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
# (B, H, ff): one encoder layer, T = 1500, d = 64 H
TAIL_SHAPES = {"tail_tiny": (16, 6, 1536), "tail_turbo": (4, 20, 5120)}
SHAPES = {"self": (16, 224, 448, 6, 224, True),
          "cross": (16, 224, 1500, 6, 1500, False),
          "encoder": (16, 1500, 1500, 6, 1500, False),
          "encoder_turbo": (4, 1500, 1500, 20, 1500, False)}
# the non-causal passes of flash's backward, and the tail's product tiles
# (csrc/encoder_tail_bwd.cu gemm<OP>, in its Op order)
PASSES = {p: p + "ILb0" for p in ("dkdv_kernel", "dq_kernel")}
PRODUCTS = {p: f"4gemmILi{i}E" for i, p in enumerate(
    ("z", "u", "dt1", "dw2", "dw1", "dy", "dwo", "da"))}
# the tail backward's kernels by name: the attention's (flash_attention_bwd),
# the row and column passes; any other kernel is a product (the tiles and
# their split reduction, or a library GEMM) unless it is PyTorch's own
ATTENTION = ("delta_kernel", "dkdv_kernel", "dq_kernel")
TAIL_PASSES = ("ln_forward", "ln_backward", "gelu_backward", "colsum")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def build_info(build, sass: bool, symbols: dict) -> dict:
    """ptxas lines (and SASS opcode counts) of the kernels whose mangled
    name holds one of `symbols`' values, by its key."""
    so, _, log = build.build()

    def key_of(line):
        return next((k for k, v in symbols.items() if v in line), None)

    info, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = key_of(line)
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
                fn = key_of(line)
            elif fn and "/*" in line:
                ops = [t for t in line.split("*/", 1)[-1].split(";")[0]
                       .split() if not t.startswith("@")]
                if ops:
                    counts.setdefault(fn, collections.Counter())[ops[0]] += 1
        for p, c in counts.items():
            info[p + "_sass"] = dict(c.most_common(16))
    return info


def events_ms(fn, iters: int) -> float:
    """Mean ms of fn() over `iters` back-to-back calls, by CUDA events,
    after a warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kind_of(kernel: str) -> str:
    if any(k in kernel for k in ATTENTION):
        return "attention"
    if any(k in kernel for k in TAIL_PASSES):
        return "passes"
    if "at::" in kernel:
        return "torch"
    return "products"


def tail_inputs(B: int, H: int, ff: int, g):
    """A layer's tail operands (T = 1500, d = 64 H), fp32 on the card:
    the matrices at 1/sqrt(fan-in), the biases and LN vectors non-zero."""
    import torch
    T, d = 1500, 64 * H

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).cuda()

    return [r(B, T, H, 64), r(B, H, T, 64), r(B, H, T, 64), r(B, T, d),
            r(d, d, scale=d ** -0.5), r(d, ff, scale=d ** -0.5),
            r(ff, d, scale=ff ** -0.5), r(d, scale=0.1), r(ff, scale=0.1),
            r(d, scale=0.1), r(d, scale=0.2, shift=1.0), r(d, scale=0.1)]


def tail_times(iters: int) -> dict:
    """Per TAIL_SHAPES entry: the tail backward's ms, its error share,
    rerun equality, bytes allocated and device ms by kernel."""
    import torch
    from torch.autograd import DeviceType

    from whisper_tpu_torch.ops import encoder_layer as el
    out = {}
    for name, (B, H, ff) in TAIL_SHAPES.items():
        g = torch.Generator().manual_seed(1)
        args = tail_inputs(B, H, ff, g)
        fwd, (attn, lse) = el._forward_for_grad(*args, eps=1e-5)
        bargs = (*args, attn, lse, torch.randn(fwd.shape, generator=g).cuda())
        del fwd
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = el.encoder_block_tail_backward(*bargs)
        torch.cuda.synchronize()
        alloc = torch.cuda.max_memory_allocated() - base
        again = el.encoder_block_tail_backward(*bargs)
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = el.encoder_block_tail_backward_plain(*bargs)
        share = max(float((a.double() - b.double()).abs().max())
                    / (1e-5 * float(b.double().abs().max()) + 1e-6)
                    for a, b in zip(got, want))
        del got, want
        ms = events_ms(lambda: el.encoder_block_tail_backward(*bargs), iters)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                el.encoder_block_tail_backward(*bargs)
            torch.cuda.synchronize()
        kernels = {e.key[:90]: e.self_device_time_total / 3e3
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        kinds = collections.Counter()
        for k, v in kernels.items():
            kinds[kind_of(k)] += v
        out[name] = {"ms": ms, "err_over_tol": share, "bit_equal_rerun": equal,
                     "alloc_mb": alloc / 1e6, "device_ms_by_kind": kinds,
                     "device_ms_by_kernel": dict(sorted(
                         kernels.items(), key=lambda kv: -kv[1]))}
        del bargs, args, attn, lse
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--tail", action="store_true",
                    help="time the encoder tail's backward instead")
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
            "card": card_line(),
            "build": build_info(_build, opts.sass,
                                PRODUCTS if opts.tail else PASSES)}
    if opts.tail:
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain twin
        line.update(tail_times(opts.iters))
        print(json.dumps(line), flush=True)
        return 0
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
