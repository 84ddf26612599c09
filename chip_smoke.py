#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (whisper_tpu_torch) on one NVIDIA
GPU: builds the kernels, holds each against its plain PyTorch version,
drives two main paths through the user entry points (batch 32, bf16, 89
greedy tokens: Whisper-tiny, whose encoder runs the fused tail kernel,
and Whisper large-v3-turbo at full width and depth, whose encoder runs
the tail-off branch through the flash-attention kernel), checks fp32
token parity with the CPU for both, and runs the CLI once.

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus the measurements of PERF.md

`--profile` adds, after each main path: the wall of five more main-path
runs, the peak device memory, and one main-path run under torch.profiler
(device time by kernel); for tiny also the fp32 tail against its plain
version at b32 and the append's device time under CUDA-graph replay.

Every line but the last is one JSON object per phase (plus the card's
`nvidia-smi` name and power limit on a line of its own). The line before
the last lists the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero without that line.
It needs CUDA: without it, or without the whisper_tpu_torch package
beside it, it exits non-zero before printing any result. It never
imports jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

BATCH = 32            # the bench workload (bench.py:45-46)
GEN_TOKENS = 89       # first pick + 88 loop steps
TAIL_CHECK_BATCH = 4  # kernel-vs-plain checks at tiny width
TURBO = "large-v3-turbo"
# flash kernel against its plain version. fp32: online softmax and fp32
# FMAs against a two-pass softmax and cuBLAS fp32, summed in other orders.
# bf16: about one bf16 ulp of the output, where the kernel rounds p at a
# running max and the plain version at the final one.
FLASH_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-3, 1e-2)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events, after warm-up."""
    import torch
    for _ in range(3):
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


def alternate_ms(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def tail_inputs(cfg, B: int, dtype, seed: int):
    """Tiny-width tail operands with non-zero biases and LN parameters
    (a random init's are zeros and ones)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    T, H, D, d, ff = cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim, \
        cfg.d_model, cfg.d_ff

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=g) * scale + shift).cuda()

    mats = [r(B, T, H, D), r(B, H, T, D), r(B, H, T, D), r(B, T, d),
            r(d, d, scale=0.05), r(d, ff, scale=0.05), r(ff, d, scale=0.05)]
    vecs = [r(d, scale=0.1), r(ff, scale=0.1), r(d, scale=0.1),
            r(d, scale=0.2, shift=1.0), r(d, scale=0.1)]
    return [m.to(dtype) for m in mats] + vecs


def bench_audio(cfg, batch: int) -> np.ndarray:
    """The bench's synthetic 30 s clips (bench.py:154-160)."""
    rng = np.random.RandomState(0)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    return np.stack([0.3 * np.sin(2 * np.pi * (200 + 40 * b) * t)
                     + 0.05 * rng.randn(cfg.n_samples)
                     for b in range(batch)]).astype(np.float32)


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device ms per fn() call, captured `launches` times in one CUDA
    graph and timed over `replays` replays: the launch cost of the host
    is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def profile_kernels(cfg, card: str, append_args) -> None:
    """The tiny kernel measurements behind PERF.md, each on its own line."""
    import torch

    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
    )
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_plain,
    )

    args = tail_inputs(cfg, BATCH, torch.float32, seed=2)
    ms, plain_ms = alternate_ms(lambda: encoder_block_tail_plain(*args),
                                lambda: encoder_block_tail(*args), iters=5)
    emit({"phase": "profile_tail_fp32", "shape": [BATCH, cfg.n_audio_ctx,
                                                  cfg.n_heads, cfg.head_dim],
          "ms": ms, "plain_ms": plain_ms, "card": card})
    del args
    torch.cuda.empty_cache()

    for dtype, (ck, cv, kn, vn) in append_args.items():
        emit({"phase": "profile_append_graph", "dtype": str(dtype),
              "shape": list(ck.shape),
              "plain_ms": graph_ms(
                  lambda: cache_append_rows_plain(ck, cv, kn, vn, 63)),
              "ms": graph_ms(lambda: cache_append_rows(ck, cv, kn, vn, 63)),
              "card": card})


def profile_path(model: str, cfg, card: str, run) -> None:
    """Five more main-path walls, the peak device memory, and one run
    under torch.profiler (device time by kernel)."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    median = float(np.median(walls))
    emit({"phase": "profile_main_path_walls", "model": model,
          "walls_s": walls, "median_s": median,
          "audio_s_per_wall_s": BATCH * cfg.chunk_length_s / median,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    emit({"phase": "profile_device_time", "model": model,
          "device_ms": device_ms, "unprofiled_median_wall_ms": 1e3 * median,
          "device_busy_share": device_ms / (1e3 * median), "card": card})
    for e in kernels[:20]:
        emit({"phase": "profile_kernel", "model": model,
              "kernel": e.key[:120],
              "device_ms": e.self_device_time_total / 1e3,
              "count": e.count})


def main_path(pipe, kernels: dict, expect: dict, card: str):
    """The bench workload through pipe.transcribe_batch: a warm-up, then
    one run with every kernel's launch count set to 0 just before it and
    read just after it. Fails unless the counts equal `expect` and the
    output is sane. Returns (run, audio, bias, launches)."""
    import torch
    cfg = pipe.cfg
    audio = bench_audio(cfg, BATCH)
    bias = torch.zeros(cfg.vocab_size, device="cuda")
    bias[cfg.eot_token] = -1e9          # EOT banned: fixed work
    max_new = GEN_TOKENS - 1

    def run():
        res = pipe.transcribe_batch(audio, max_new=max_new, logit_bias=bias)
        torch.cuda.synchronize()
        return res

    run()                               # warm-up
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    P = 4
    toks = res.tokens.cpu()
    gen = toks[:, P:]
    emit({"phase": "main_path", "model": cfg.name, "dtype": "bfloat16",
          "batch": BATCH, "gen_tokens": GEN_TOKENS, "wall_s": wall,
          "audio_s_per_wall_s": BATCH * cfg.chunk_length_s / wall,
          "launches": launches, "card": card})
    for name, n in expect.items():
        require(launches[name] == n,
                f"{cfg.name}: {name} launches {launches[name]} != {n}")
    require(tuple(toks.shape) == (BATCH, P + GEN_TOKENS),
            f"tokens shape {tuple(toks.shape)}")
    require(bool((gen != cfg.eot_token).all()), "EOT emitted while banned")
    require(bool((gen >= 0).all() and (gen < cfg.vocab_size).all()),
            "token ids outside the vocab")
    require(bool(torch.isfinite(res.sum_logprobs).all()),
            "non-finite sum_logprobs")
    nsp = res.no_speech_prob
    require(bool(((nsp >= 0) & (nsp <= 1)).all()), "no_speech_prob off [0,1]")
    return run, audio, bias, launches


def main_path_stages(pipe, audio, bias, card: str) -> None:
    """Where the main path's time goes (host clock, synchronised per
    stage)."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_loop, _greedy_prefill, encode
    P, max_new = 4, GEN_TOKENS - 1
    stages = {}
    t = time.perf_counter()
    wav = torch.from_numpy(audio).cuda()
    mel = log_mel_spectrogram(wav, pipe.cfg)
    torch.cuda.synchronize()
    stages["mel_s"] = time.perf_counter() - t
    t = time.perf_counter()
    enc = encode(pipe.params, pipe.cfg, mel)
    torch.cuda.synchronize()
    stages["encoder_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        prompt = pipe.prompt(BATCH)
        pre = _greedy_prefill(pipe.params, pipe.cfg, enc, prompt,
                              P + GEN_TOKENS)
        torch.cuda.synchronize()
        stages["prefill_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _greedy_loop(pipe.params, pipe.cfg, *pre, prompt, bias, max_new)
        torch.cuda.synchronize()
    stages["loop_s"] = time.perf_counter() - t
    stages["loop_ms_per_step"] = 1e3 * stages["loop_s"] / max_new
    emit({"phase": "main_path_stages", "model": pipe.cfg.name, **stages,
          "card": card})


def fp32_parity(model: str, params, clips: np.ndarray, max_new: int,
                bf16_tokens, vocab_path=None) -> dict:
    """fp32 on the card against the CPU's plain versions, from the same
    params: tokens, prefill logits and encoder output. Fails unless the
    tokens are identical and the logits agree to 1e-3."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_prefill, encode, greedy_decode
    from whisper_tpu_torch.pipeline import WhisperPipeline
    P = 4
    runs = {}
    for name, device in (("gpu", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        p32 = WhisperPipeline.from_params(params, model, dtype="float32",
                                          device=device,
                                          vocab_path=vocab_path)
        wav = torch.from_numpy(clips).to(device)
        enc = encode(p32.params, p32.cfg, log_mel_spectrogram(wav, p32.cfg))
        prompt = p32.prompt(len(clips))
        with torch.inference_mode():
            _, _, _, logits = _greedy_prefill(p32.params, p32.cfg, enc,
                                              prompt, P + 1 + max_new)
        res = greedy_decode(p32.params, p32.cfg, enc, prompt,
                            max_new=max_new)
        runs[name] = (res.tokens.cpu(), logits.cpu(), enc.cpu(),
                      time.perf_counter() - t0)
        del p32, wav, enc, logits, res
        torch.cuda.empty_cache()
    same_tokens = bool(torch.equal(runs["gpu"][0], runs["cpu"][0]))
    logit_err = float((runs["gpu"][1] - runs["cpu"][1]).abs().max())
    enc_err = float((runs["gpu"][2] - runs["cpu"][2]).abs().max())
    agree16 = float((bf16_tokens[:, P:] == runs["gpu"][0][:, P:]
                     ).float().mean())
    out = {"model": model, "batch": len(clips), "max_new": max_new,
           "tokens_identical": same_tokens, "tokens": runs["gpu"][0].tolist(),
           "prefill_logits_max_abs_err": logit_err,
           "encoder_max_abs_err": enc_err,
           "bf16_token_agreement_with_fp32": agree16,
           "gpu_s": runs["gpu"][3], "cpu_s": runs["cpu"][3]}
    require(same_tokens, f"{model}: fp32 tokens differ between GPU and CPU")
    # 1e-3: fp32 logits of order 10, GPU kernels against CPU torch summing
    # in other orders (TF32 would miss this by ~100x)
    require(logit_err < 1e-3,
            f"{model}: fp32 prefill logits differ by {logit_err}")
    return out


def tail_gate(card: str) -> None:
    """The encoder's gate (ops/encoder_layer.py tail_fits_smem) against
    the kernel's own answer at every width of the family: the tail kernel
    must run where the gate says it fits and refuse where it does not."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        tail_fits_smem,
        tail_smem_bytes,
    )
    dev = torch.device("cuda")
    rows = []
    for name in ("tiny", "base", "small", "medium", TURBO):
        cfg = get_config(name)
        fits = tail_fits_smem(cfg.d_model, cfg.d_ff, dev)
        args = tail_inputs(cfg, 1, torch.bfloat16, seed=4)
        try:
            encoder_block_tail(*args)
            torch.cuda.synchronize()
            runs = True
        except RuntimeError as e:       # the kernel's refusal, nothing else
            if "(invalid argument)" not in str(e):
                raise
            runs = False
        rows.append({"model": name, "d": cfg.d_model,
                     "smem_bytes": tail_smem_bytes(cfg.d_model, cfg.d_ff),
                     "gate_fits": fits, "kernel_runs": runs})
        del args
    ok = all(r["gate_fits"] == r["kernel_runs"] for r in rows)
    emit({"phase": "tail_gate", "smem_optin": torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin, "widths": rows, "ok": ok,
          "card": card})
    require(ok, "the tail gate disagrees with the tail kernel")
    require([r["gate_fits"] for r in rows] == [True, True, False, False,
                                               False],
            "tiny and base must take the tail, small and up must not")


def flash_checks(card: str) -> dict:
    """The flash kernel against its plain version at the shapes the port
    gives it (turbo: H=20, D=64), then one turbo b32 encoder layer timed
    against the plain version. Returns the kernels-line numbers (bf16
    b32)."""
    import torch

    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    H, D = 20, 64
    cases = {     # B, T, S, kv_len, q_offset, causal
        "a_encoder": (4, 1500, 1500, None, 0, False),
        "b_cross_prefill": (32, 4, 1500, None, 0, False),
        "c_causal_prefill": (32, 4, 128, 4, 0, True),
        "d_causal_offset": (32, 40, 448, 140, 100, True),
        "e_kv_len_0": (4, 4, 128, 0, 0, False),
    }
    g = torch.Generator(device="cpu").manual_seed(5)

    def inputs(B, T, S, dtype):
        return [torch.randn(s, generator=g).to("cuda", dtype)
                for s in ((B, T, H, D), (B, H, S, D), (B, H, S, D))]

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = FLASH_TOL[str(dtype).split(".")[1]]
        for name, (B, T, S, kv_len, q_offset, causal) in cases.items():
            q, k, v = inputs(B, T, S, dtype)
            got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
            want = flash_attention_plain(q, k, v, kv_len, q_offset,
                                         causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if kv_len == 0:
                ok = ok and not bool(got.any())
            line = {"phase": "flash_vs_plain", "case": name,
                    "dtype": str(dtype), "shape": [B, T, H, D], "S": S,
                    "kv_len": kv_len, "q_offset": q_offset, "causal": causal,
                    "max_abs_err": float(err.max()), "atol": atol,
                    "rtol": rtol, "ok": ok}
            if causal:                  # (f): NaN past kv_len never read
                k[:, :, kv_len:] = float("nan")
                v[:, :, kv_len:] = float("nan")
                poisoned = flash_attention(q, k, v, kv_len, q_offset,
                                           causal=causal)
                torch.cuda.synchronize()
                line["nan_past_kv_len_unread"] = bool(
                    torch.equal(poisoned, got))
                ok = ok and line["nan_past_kv_len_unread"]
                line["ok"] = ok
            emit(line)
            require(ok, f"flash_attention {dtype} case {name} disagrees with "
                        f"its plain version (max abs err {float(err.max())})")
            del q, k, v, got, want, err
    torch.cuda.empty_cache()

    # one turbo b32 encoder layer, timed in turns; the plain version
    # materialises 32*20*1500^2*4 B = 5.8 GB of scores
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = FLASH_TOL[str(dtype).split(".")[1]]
        q, k, v = inputs(BATCH, 1500, 1500, dtype)
        got = flash_attention(q, k, v).float()
        want = flash_attention_plain(q, k, v).float()
        err = (got - want).abs()
        max_err = float(err.max())
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"flash_attention b32 {dtype} max abs err {max_err}")
        del got, want, err
        ms, plain_ms = alternate_ms(lambda: flash_attention_plain(q, k, v),
                                    lambda: flash_attention(q, k, v),
                                    iters=5)
        emit({"phase": "flash_time", "shape": [BATCH, 1500, H, D],
              "dtype": str(dtype), "max_abs_err": max_err, "ms": ms,
              "plain_ms": plain_ms,
              "tflops": 4 * BATCH * H * 1500 * 1500 * D / (ms * 1e9),
              "card": card})
        if dtype == torch.bfloat16:     # the main path's dtype
            out = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def write_v3_vocab(tokens: list, directory: str) -> str:
    """The 51,866-entry table of large-v3 and turbo: the bundled table
    with <|yue|>, the 100th language, at id 50358 (the layout of
    whisper_tpu/config.py:118, :150-180)."""
    tokens = list(tokens)
    tokens.insert(50_358, "<|yue|>")
    path = os.path.join(directory, "vocab_v3.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also take the measurements of PERF.md")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from whisper_tpu_torch import cli, get_config, weights
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
    )
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_plain,
    )
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.pipeline import WhisperPipeline

    # the plain fp32 oracles run in full fp32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tiny")
    kernels = {"encoder_block_tail": encoder_block_tail,
               "cache_append_rows": cache_append_rows,
               "flash_attention": flash_attention}

    # 1. card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "kind": kind, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    so, build_s, log = _build.build()
    _build.load_library()
    emit({"phase": "build", "seconds": round(build_s, 3),
          "library": os.path.relpath(so),
          "ptxas": [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]})

    # 3. kernels against their plain versions at the main paths' shapes
    tail_tol = {torch.float32: (1e-4, 0.0), torch.bfloat16: (0.06, 2e-2)}
    for dtype, (atol, rtol) in tail_tol.items():
        args = tail_inputs(cfg, TAIL_CHECK_BATCH, dtype, seed=1)
        got = encoder_block_tail(*args).float()
        want = encoder_block_tail_plain(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= atol + rtol * want.abs()).all())
        emit({"phase": "tail_vs_plain", "dtype": str(dtype),
              "shape": [TAIL_CHECK_BATCH, cfg.n_audio_ctx, cfg.n_heads,
                        cfg.head_dim], "max_abs_err": float(err.max()),
              "atol": atol, "rtol": rtol, "ok": ok})
        require(ok, f"encoder_block_tail {dtype} disagrees with its plain "
                    f"version (max abs err {float(err.max())})")
    # the main path's own shape: b32 bf16
    args = tail_inputs(cfg, BATCH, torch.bfloat16, seed=2)
    got = encoder_block_tail(*args).float()
    want = encoder_block_tail_plain(*args).float()
    main_tail_err = float((got - want).abs().max())
    require(bool(((got - want).abs() <= 0.06 + 2e-2 * want.abs()).all()),
            f"encoder_block_tail b32 bf16 max abs err {main_tail_err}")
    del got, want
    tail_ms, tail_plain_ms = alternate_ms(
        lambda: encoder_block_tail_plain(*args),
        lambda: encoder_block_tail(*args), iters=5)
    emit({"phase": "tail_time", "shape": [BATCH, cfg.n_audio_ctx,
                                          cfg.n_heads, cfg.head_dim],
          "dtype": "bfloat16", "max_abs_err": main_tail_err,
          "ms": tail_ms, "plain_ms": tail_plain_ms, "card": card})
    del args
    torch.cuda.empty_cache()
    tail_gate(card)

    L, H, S, D = cfg.n_text_layers, cfg.n_heads, 128, cfg.head_dim
    shape = (L, BATCH, H, S, D)
    g = torch.Generator(device="cpu").manual_seed(3)
    append_err = 0.0
    append_args = {}
    for dtype in (torch.float32, torch.bfloat16):
        for pos in (0, 5, 63, 127):
            ck = torch.randn(shape, generator=g).to("cuda", dtype)
            cv = torch.randn(shape, generator=g).to("cuda", dtype)
            kn = torch.randn(shape[:3] + (D,), generator=g).to("cuda", dtype)
            vn = torch.randn(shape[:3] + (D,), generator=g).to("cuda", dtype)
            want_k, want_v = cache_append_rows_plain(ck.clone(), cv.clone(),
                                                     kn, vn, pos)
            ptrs = (ck.data_ptr(), cv.data_ptr())
            ok_k, ok_v = cache_append_rows(ck, cv, kn, vn, pos)
            torch.cuda.synchronize()
            same = (ok_k.data_ptr(), ok_v.data_ptr()) == ptrs
            append_err = max(append_err,
                             float((ok_k.float() - want_k.float()).abs().max()),
                             float((ok_v.float() - want_v.float()).abs().max()))
            exact = bool(torch.equal(ok_k, want_k) and torch.equal(ok_v, want_v))
            emit({"phase": "append_vs_plain", "dtype": str(dtype), "pos": pos,
                  "shape": list(shape), "exact": exact, "in_place": same})
            require(exact and same, f"cache_append_rows {dtype} pos {pos}: "
                                    f"exact={exact} in_place={same}")
        append_args[dtype] = (ck, cv, kn, vn)
    append_ms, append_plain_ms = alternate_ms(
        lambda: cache_append_rows_plain(ck, cv, kn, vn, 63),
        lambda: cache_append_rows(ck, cv, kn, vn, 63), iters=200)
    emit({"phase": "append_time", "shape": list(shape), "dtype": "bfloat16",
          "ms": append_ms, "plain_ms": append_plain_ms, "card": card})

    flash = flash_checks(card)

    # 4. tiny main path: the bench workload through the pipeline
    params = weights.init_params(cfg, seed=0)
    pipe = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                       device="cuda")
    run, audio, bias, tiny_launches = main_path(
        pipe, kernels, {"encoder_block_tail": cfg.n_audio_layers,
                        "cache_append_rows": GEN_TOKENS - 1,
                        "flash_attention": 0}, card)
    main_path_stages(pipe, audio, bias, card)
    if opts.profile:
        profile_kernels(cfg, card, append_args)
        profile_path("tiny", cfg, card, run)
    bundled_vocab = pipe.tokenizer.tokens
    del pipe, run, append_args
    torch.cuda.empty_cache()

    # 5. tiny fp32 parity: the card against the CPU's plain versions
    clips = bench_audio(cfg, 2)
    p16 = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                      device="cuda")
    tok16 = p16.transcribe_batch(clips, max_new=12).tokens.cpu()
    del p16
    parity = fp32_parity("tiny", params, clips, 12, tok16)
    emit({"phase": "fp32_parity", **parity})

    # 6. the CLI, in process
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.wav")
        x = (clips[0][:cfg.sample_rate * 5] * 32000).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg.sample_rate)
            w.writeframes(x.tobytes())
        rc = cli.main(["--random-weights", "--audio", path, "--max-new", "8",
                       "--device", "cuda"])
    emit({"phase": "cli", "rc": rc})
    require(rc == 0, f"cli returned {rc}")
    del params
    torch.cuda.empty_cache()

    # 7. large-v3-turbo at full width and depth: the tail-off encoder
    tcfg = get_config(TURBO)
    t0 = time.perf_counter()
    tparams = weights.init_params(tcfg, seed=0)
    emit({"phase": "turbo_init_params",
          "seconds": time.perf_counter() - t0,
          "n_params": sum(int(np.prod(x.shape)) for x in
                          _leaves(tparams))})
    with tempfile.TemporaryDirectory() as tmp:
        vocab = write_v3_vocab(bundled_vocab, tmp)
        pipe = WhisperPipeline.from_params(tparams, TURBO, dtype="bfloat16",
                                           device="cuda", vocab_path=vocab)
        require(pipe.tokenizer.vocab_size == tcfg.vocab_size,
                "turbo vocab table size")
        run, audio, bias, turbo_launches = main_path(
            pipe, kernels, {"flash_attention": tcfg.n_audio_layers,
                            "encoder_block_tail": 0,
                            "cache_append_rows": GEN_TOKENS - 1}, card)
        main_path_stages(pipe, audio, bias, card)
        if opts.profile:
            profile_path(TURBO, tcfg, card, run)
        clip = bench_audio(tcfg, 1)
        tok16 = pipe.transcribe_batch(clip, max_new=8).tokens.cpu()
        del pipe, run, audio, bias
        torch.cuda.empty_cache()

        # 8. turbo fp32 parity, full depth on both sides
        parity = fp32_parity(TURBO, tparams, clip, 8, tok16, vocab)
        emit({"phase": "turbo_fp32_parity", **parity})

    # 9. results
    emit({"kernels": [
        {"name": "encoder_block_tail", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/encoder_tail.cu",
         "replaces": "whisper_tpu/ops/encoder_layer.py:240",
         "launches": tiny_launches["encoder_block_tail"],
         "max_abs_err": main_tail_err, "ms": tail_ms,
         "plain_ms": tail_plain_ms},
        {"name": "cache_append_rows", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/cache_append.cu",
         "replaces": "whisper_tpu/ops/cache_append.py:62",
         "launches": tiny_launches["cache_append_rows"],
         "max_abs_err": append_err,
         "ms": append_ms, "plain_ms": append_plain_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/flash_attention.cu",
         "replaces": "whisper_tpu/ops/flash_attention.py:112",
         "launches": turbo_launches["flash_attention"],
         "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
         "plain_ms": flash["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
