#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (whisper_tpu_torch) on one NVIDIA
GPU: builds the kernels, holds each against its plain PyTorch version,
drives the main path (Whisper-tiny, batch 32, bf16, 89 greedy tokens)
through the user entry points, checks fp32 token parity with the CPU, and
runs the CLI once.

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus the measurements of PERF.md

`--profile` adds, after the main path: the fp32 tail against its plain
version at b32, the append's device time under CUDA-graph replay, the
wall of five more main-path runs, the peak device memory, and one
main-path run under torch.profiler (device time by kernel).

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


def profile(cfg, card: str, run, append_args) -> None:
    """The measurements behind PERF.md, each on its own line."""
    import torch
    from torch.autograd import DeviceType

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

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    median = float(np.median(walls))
    emit({"phase": "profile_main_path_walls", "walls_s": walls,
          "median_s": median,
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
    emit({"phase": "profile_device_time", "device_ms": device_ms,
          "unprofiled_median_wall_ms": 1e3 * median,
          "device_busy_share": device_ms / (1e3 * median), "card": card})
    for e in kernels[:20]:
        emit({"phase": "profile_kernel", "kernel": e.key[:120],
              "device_ms": e.self_device_time_total / 1e3,
              "count": e.count})


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
    from whisper_tpu.config import get_config
    from whisper_tpu_torch import cli, weights
    from whisper_tpu_torch.decode import _greedy_prefill, encode
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
    )
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_plain,
    )
    from whisper_tpu_torch.pipeline import WhisperPipeline

    # the plain fp32 oracles run in full fp32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tiny")

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

    # 3. kernels against their plain versions at the main path's shapes
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

    # 4. main path: the bench workload through the pipeline
    params = weights.init_params(cfg, seed=0)
    pipe = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                       device="cuda")
    audio = bench_audio(cfg, BATCH)
    bias = torch.zeros(cfg.vocab_size, device="cuda")
    bias[cfg.eot_token] = -1e9          # EOT banned: fixed work
    max_new = GEN_TOKENS - 1

    def run():
        res = pipe.transcribe_batch(audio, max_new=max_new, logit_bias=bias)
        torch.cuda.synchronize()
        return res

    run()                               # warm-up
    encoder_block_tail.launches = 0
    cache_append_rows.launches = 0
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = {"encoder_block_tail": encoder_block_tail.launches,
                "cache_append_rows": cache_append_rows.launches}
    P = 4
    toks = res.tokens.cpu()
    gen = toks[:, P:]
    emit({"phase": "main_path", "model": "tiny", "dtype": "bfloat16",
          "batch": BATCH, "gen_tokens": GEN_TOKENS, "wall_s": wall,
          "audio_s_per_wall_s": BATCH * cfg.chunk_length_s / wall,
          "launches": launches, "card": card})
    require(launches["encoder_block_tail"] == cfg.n_audio_layers,
            f"tail launches {launches['encoder_block_tail']} != "
            f"{cfg.n_audio_layers} per encoder pass")
    require(launches["cache_append_rows"] == max_new,
            f"append launches {launches['cache_append_rows']} != {max_new}")
    require(tuple(toks.shape) == (BATCH, P + GEN_TOKENS),
            f"tokens shape {tuple(toks.shape)}")
    require(bool((gen != cfg.eot_token).all()), "EOT emitted while banned")
    require(bool((gen >= 0).all() and (gen < cfg.vocab_size).all()),
            "token ids outside the vocab")
    require(bool(torch.isfinite(res.sum_logprobs).all()),
            "non-finite sum_logprobs")
    nsp = res.no_speech_prob
    require(bool(((nsp >= 0) & (nsp <= 1)).all()), "no_speech_prob off [0,1]")

    # where the main path's time goes (host clock, synchronised per stage)
    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_loop
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
    emit({"phase": "main_path_stages", **stages, "card": card})
    del pre, enc, mel
    if opts.profile:
        profile(cfg, card, run, append_args)
    del pipe, append_args
    torch.cuda.empty_cache()

    # 5. fp32 parity: the card against the CPU's plain versions
    clips = bench_audio(cfg, 2)
    runs = {}
    for name, device in (("gpu", "cuda"), ("cpu", "cpu")):
        p32 = WhisperPipeline.from_params(params, "tiny", dtype="float32",
                                          device=device)
        wav = torch.from_numpy(clips).to(device)
        enc = encode(p32.params, p32.cfg, log_mel_spectrogram(wav, p32.cfg))
        with torch.inference_mode():
            _, _, _, logits = _greedy_prefill(p32.params, p32.cfg, enc,
                                              p32.prompt(2), 17)
        r = p32.transcribe_batch(clips, max_new=12)
        runs[name] = (r.tokens.cpu(), logits.cpu(), enc.cpu())
    p16 = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                      device="cuda")
    tok16 = p16.transcribe_batch(clips, max_new=12).tokens.cpu()
    same_tokens = bool(torch.equal(runs["gpu"][0], runs["cpu"][0]))
    logit_err = float((runs["gpu"][1] - runs["cpu"][1]).abs().max())
    enc_err = float((runs["gpu"][2] - runs["cpu"][2]).abs().max())
    agree16 = float((tok16[:, P:] == runs["gpu"][0][:, P:]).float().mean())
    emit({"phase": "fp32_parity", "tokens_identical": same_tokens,
          "tokens": runs["gpu"][0].tolist(), "prefill_logits_max_abs_err":
          logit_err, "encoder_max_abs_err": enc_err,
          "bf16_token_agreement_with_fp32": agree16})
    require(same_tokens, "fp32 tokens differ between GPU and CPU")
    # 1e-3: fp32 logits of order 10 through 8 layers, GPU kernels against
    # CPU torch summing in other orders (TF32 would miss this by ~100x)
    require(logit_err < 1e-3, f"fp32 prefill logits differ by {logit_err}")

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

    # 7. results
    emit({"kernels": [
        {"name": "encoder_block_tail", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/encoder_tail.cu",
         "replaces": "whisper_tpu/ops/encoder_layer.py:240",
         "launches": launches["encoder_block_tail"],
         "max_abs_err": main_tail_err, "ms": tail_ms,
         "plain_ms": tail_plain_ms},
        {"name": "cache_append_rows", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/cache_append.cu",
         "replaces": "whisper_tpu/ops/cache_append.py:62",
         "launches": launches["cache_append_rows"],
         "max_abs_err": append_err,
         "ms": append_ms, "plain_ms": append_plain_ms},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
