#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (whisper_tpu_torch) on one NVIDIA
GPU: builds the kernels, holds each against its plain PyTorch version
(and times it beside its bound and, where one exists, the one PyTorch call
for the same function), drives two greedy main paths through the user
entry points (batch 32, bf16, 89 greedy tokens: Whisper-tiny, whose
encoder runs the fused tail kernel, and Whisper large-v3-turbo at full
width and depth, whose encoder runs it too; the turbo encoder's tail-off
branch through the flash-attention kernel, WHISPER_TPU_FUSED_ENCODER=0,
in turns against it), checks fp32 token parity with the CPU for both,
runs the CLI once, and drives the continuous-batching engine
(ContinuousBatcher: tiny with 32 slots and 96 requests, turbo with 8
slots and 16 requests, bf16, two requests arriving before every second
step; every step ends in one ragged append) and holds its tokens to a
solo run and to greedy decoding. Then the int8 serving stack: the
int8-cache decode kernel (decode_attention_q8_bh / decode_attention_q8)
and the int8 append against their plain versions, tiny b32 bf16 and turbo
b32 bf16 with the serving policy (quant="auto", turbo also with the int8
self cache), each timed against quant="off" in the same process, and
tiny b32 fp32 with an int8 cross cache, whose every cross read launches
the int8 decode kernel and whose tokens equal the CPU's. Then the fused
decoder step (cfg.fused_step): fused_decoder_step against its plain
version at tiny and turbo widths and timed beside its bound and the
unfused step, the tiny b32 bf16 workload with the fused step (one
fused_decoder_step and one append launch per loop step) timed against
the unfused path in turns, tiny fp32 with the fused step against the CPU
and the unfused tokens, and turbo b32 bf16 with the fused step at full
width and depth. Then the attention backend switch (cfg.attn_backend):
the fp32/bf16 decode kernel's three wrappers (decode_attention_bh,
decode_attention_bg, decode_attention) against their plain versions with
NaN in the dead rows and timed beside the bound and SDPA, and the reads
its plan splits (B=1 and B=4 cross reads, a long cache) timed split and
in one block beside SDPA, and the wall time of a decode wrapper's call;
tiny and turbo
b32 bf16 under "pallas" with WHISPER_TPU_IP_CROSS=bg8 (every cross read
of the loop one decode_attention_bg launch) timed against the default
path in turns; tiny b32 bf16 with kv_cache_quant under "pallas" (every
T==1 step read one decode_attention_bh launch) and its fp32 tokens
against the CPU; and the tiny engine under "pallas". Then beam search and
sampling: tiny b32 and turbo b8 x beam 5 (bf16, 89 tokens) through the
pipeline, with beam 1 against greedy on the card; tiny fp32 x beam 5 on
the card against the CPU, also with the int8 cross cache (every cross
read one decode_attention_q8_bh launch); temperature sampling through
the pipeline (seeded, no masked token drawn) and the engine (a request's
draws independent of its companions); and the CLI with --beam and
--temperature from a checkpoint that the port's save_npz wrote. Then the
rest of int8: the tail kernel's int8 form (encoder_block_tail_q8, tiny to
turbo widths) and the ragged append on int8 rows against their plain
versions, timed beside their bounds; turbo b32 under the serving policy
(one int8 tail launch a layer); tiny b32 bf16 through the pipeline with
the encoder's int8 tail (encoder_mlp_quant + encoder_qkv_quant: one int8
tail launch a layer) and with encoder_quant (no tail launch), each
against the unquantized path in turns and its logits against the CPU;
and the engine on int8 caches: tiny (32 slots, 96 requests) and medium at
full width and depth (8 slots, 16 requests; its int8 self cache takes one
int8 ragged append a step, its encoder one int8 tail launch a layer)
under quant="auto" as the JAX server builds the engine,
and tiny fp32 with the int8 cross cache under "pallas_interpret" (every
cross read one decode_attention_q8_bh launch; tokens equal to the CPU
engine's), each request's tokens equal to its solo run. Then the
pipeline layer: long-form transcription of a 75 s clip (timestamps with
seek, conditioning on the previous window, word timestamps, 32 tokens a
window) at tiny fp32 on the card against the CPU (tokens, text and
segments equal, word times within one frame) and at large-v3-turbo bf16
(full width and depth: one tail launch a layer a window, one append a
step, as the code implies); speculative decoding with medium at full
width and depth as the target, the tiny draft and medium as its own
draft, k = 4, in fp32 and bf16 (tokens equal to the target's greedy),
and under "pallas" (flash and decode_attention_bh launches as the round
statistics imply); and the CLI with a 45 s 22.05 kHz WAV (the native
loader, word timestamps, SRT, the VAD gate) and with small and the tiny
draft. Then the serving layer: `python -m whisper_tpu_torch.server` as a
user starts it (tiny from a flat-bin file, bf16 under quant="auto", three
processes: the continuous engine under benchmarks/server_load.py's mix of
8 clients at 22.05 kHz, half on SSE, every 4th a 75 s file; a
--max-queue 1 server under a burst, which answers 503 with Retry-After;
the dynamic batcher gathering 8 concurrent 30 s posts into one batch);
large-v3-turbo at full width and depth under quant="auto" behind the HTTP
front (16 SSE clients through a ContinuousEngine of 8 slots: TTFT,
inter-token gap, completion wall, RTFx, launches as the fills and steps
imply, each short request equal to its solo run; a BatchedTranscriber
batch of 8; recovery from a poisoned step); and tiny fp32 served by
both engines on the card, its tokens equal to the CPU's. Then
fine-tuning: the teacher-forced train step (whisper_tpu_torch.train) in
fp32 on tiny at full width and depth (6 steps on a fixed batch of 16 x
224 tokens: the loss falls, each step's forward launches the tail once a
layer and flash for each decoder read, the backward launches none, every
gradient finite and every leaf's non-zero but the key biases'), one
step's gradients on the card against the CPU (B=8), large-v3-turbo at
full width and depth (2 steps of 4 rows, the first update at lr 1e-4:
the loss moves, every leaf's gradient non-zero but the key biases'),
and the two kernels' forward
and backward (the plain twin's autograd) timed beside SDPA's. Then the
meshes (whisper_tpu_torch.parallel): large-v3-turbo bf16 at full width
and depth through ShardedPipeline on a world of one NCCL process that
make_mesh opens itself (B=8, 32 greedy tokens, equal to
WhisperPipeline's; one tail launch a layer, one append a step); then four
gloo processes sharing the card (NCCL refuses two ranks on one device;
their walls are no measure of multi-chip scaling): turbo fp32 with
tok_emb x 4 through ShardedPipeline at (dp, tp) = (1, 4), (2, 2) and
(dp, sp) = (2, 2), prefill logits and tokens against the one-card fp32
run (flash launches per rank under tp, tail launches under sp), turbo's
pipelined encoder and decoder at pp = 4, tiny's train step at pp = 4 and
(dp, tp) = (2, 2) against the one-card train_step, the MoE at ep = 4,
and a DCP checkpoint of tiny saved at tp = 4 and restored at tp = 2 and
whole, bit-equal; which collectives gloo takes on CUDA tensors is tried
on the card.

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus the measurements of PERF.md

`--only pipeline` runs the pipeline layer's phases alone (turbo's
weights drawn on the card), `--only serving` the serving layer's,
`--only train` the train phases, `--only mesh` the mesh phase (~70 s of
command); an `--only` run ends with the ok line but prints no kernels
line.
`--profile` adds the kernels' build timed serial against parallel,
three more turbo long-form walls, the speculative walls as the best of
three, the tail's launches at turbo b32 by kernel, the int8 engines under
torch.profiler, the
names of SDPA's fp32 kernels, the decode kernel by replay at forced split
counts, and after each greedy main path (of the "pallas" ones, tiny's):
the wall of five more main-path runs, the peak device memory, and one
main-path run under torch.profiler (device time by kernel); for tiny
also the append's device time under CUDA-graph replay, and one more
drive of the tiny engine's traffic under torch.profiler.

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
import contextlib
import functools
import gc
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
# the ragged append at the engines' cache shapes (L, B, H, S, D): tiny with
# 32 slots, turbo with 8, both over n_text_ctx = 448 positions
RAGGED_SHAPES = {"tiny": (4, 32, 6, 448, 64), "turbo": (4, 8, 20, 448, 64)}
ENGINE_REQUESTS, ENGINE_MAX_NEW = 96, 88               # tiny, 32 slots
TURBO_ENGINE_REQUESTS, TURBO_ENGINE_MAX_NEW = 16, 24   # turbo, 8 slots
ARRIVALS = 2          # engine requests arriving before every second step
# beam search and sampling: beam width, turbo's audio rows under beam (40
# decode rows), the fp32 parity decode, the sampling temperatures (the
# pipeline's, the engine's) and the sampling engine's traffic
BEAM, BEAM_TURBO_BATCH, BEAM_PARITY_TOKENS = 5, 8, 24
SAMPLE_T, ENGINE_SAMPLE_T = 0.7, 1.0
SAMPLE_ENGINE_REQUESTS, SAMPLE_ENGINE_MAX_NEW = 40, 24
# fp32 beam sums of 23 picks, GPU against CPU: the fp32 logits' tolerance
BEAM_LOGPROB_ATOL = 1e-3
# the int8 decode kernel against its plain version: fp32 an online
# against a two-pass softmax, summed in other orders; bf16 about one bf16
# ulp of the output
Q8_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-3, 1e-2)}
# bf16 prefill logits of the serving path on the card against the port on
# the CPU: bf16 rounding in other places (cuBLAS, the tail kernel against
# its plain version) through 8 layers, at ~0.01 per logit of a tiny random
# model; 0.1 leaves room over the largest of ~400k logits
SERVING_LOGITS_ATOL = 0.1
# fp32 prefill logits on the card against the CPU under kv_cache_quant:
# each device rounds the prompt's self K/V rows to int8, and an fp32
# difference of ~1e-6 at a rounding boundary moves a value by one int8 step
# (max|row| / 127); over a 4-token self read that reaches the logits at
# ~1.5e-3 (the unquantized bound, 1e-3, holds everywhere else)
KVQ_LOGITS_ATOL = 1e-2
# the fused decoder step against its plain version. fp32: fp32 FMAs
# against cuBLAS fp32 through up to 4 layers and two softmaxes, summed in
# other orders. bf16: one bf16 ulp of O(4) values, where a sum in another
# order lands on the other side of a rounding point and the flip is
# carried into the later layers
FUSED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.06, 2e-2)}
FUSED_POS = (0, 4, 48, 447)       # empty self cache .. the last of 448 slots
FUSED_TIME_POS = 48               # mid-bench: prompt 4 + 44 loop steps
# the fp32/bf16 decode kernel (decode_attention_bh, _bg, decode_attention)
# against its plain version. fp32: an online against a two-pass softmax,
# summed in other orders. bf16: about one bf16 ulp of the output (and of
# p, where decode_attention rounds it to bf16 V at a warp's running max
# and the plain version at the final one)
DECODE_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-3, 1e-2)}
# (B, H, S, kv_lens): tiny's self cache (448 slots), tiny's and turbo's b32
# cross reads, and a long cache past the auto gate's 4096 slots
DECODE_CASES = {"tiny_self": (BATCH, 6, 448, (0, 1, 93, 448)),
                "tiny_cross": (BATCH, 6, 1500, (None,)),
                "turbo_cross": (BATCH, 20, 1500, (None,)),
                "long_cache": (4, 6, 8192, (8000,))}
# the three shapes timed: the main paths' b32 bf16 cross reads, and the
# self read at 93 of 448 slots (the bench's prompt 4 + 89 tokens)
DECODE_TIME = {"tiny_cross": (BATCH, 6, 1500, 1500),
               "turbo_cross": (BATCH, 20, 1500, 1500),
               "tiny_self_93": (BATCH, 6, 448, 93)}
# the split counts decode_split_sweep forces
SPLIT_SWEEP = (1, 2, 3, 4, 5, 6, 8)
# (B, H, S, kv_len) of the reads whose B*H rows leave SMs without a
# block, which decode_split_ab times split by the plan and in one block:
# bf16 cross reads at B=1 (a one-file transcription's cross reads and its
# detect_language under "pallas") and B=4 (turbo's 80 rows the plan does
# not split), and the long cache
SPLIT_AB = {"tiny_cross_b1": (1, 6, 1500, 1500),
            "tiny_cross_b4": (4, 6, 1500, 1500),
            "turbo_cross_b1": (1, 20, 1500, 1500),
            "turbo_cross_b4": (4, 20, 1500, 1500),
            "long_cache": (4, 6, 8192, 8000)}
IP_CROSS_BG8 = {"WHISPER_TPU_IP_CROSS": "bg8"}
# every greedy run but the "pallas" ones launches none of these
NO_DECODE = {"decode_attention_bh": 0, "decode_attention_bg": 0,
             "decode_attention": 0}
# published NVIDIA H100 SXM peaks at 700 W (dense), for the bounds
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_INT8_OPS = 1979e12         # dense int8 tensor-core peak
# the flash kernel's bf16 timings (B, T, H, S): a turbo and a tiny b32
# encoder layer (tiny's is the tail's attention), the tiny engine fill's
# cross read at p_pad 128, and the "pallas" tiny prefill's cross read
FLASH_TIME = {"turbo_layer": (BATCH, 1500, 20, 1500),
              "tiny_layer": (BATCH, 1500, 6, 1500),
              "tiny_fill_cross": (BATCH, 128, 6, 1500),
              "tiny_prefill_cross": (BATCH, 4, 6, 1500)}
# fp32 flash timings (B, T, H, S): a turbo and a tiny b32 encoder layer
FLASH_TIME_FP32 = ("turbo_layer", "tiny_layer")
# the bf16 and fp32 flash kernels' symbols (both causal instantiations)
FLASH_BF16_KERNEL = "2tc12flash_kernel"
FLASH_FP32_KERNEL = "4simt12flash_kernel"
# the fused decoder step's kernel (both element types)
FUSED_KERNEL = "17fused_step_kernel"
# the tail's MLP tiles, by form (the template argument's mangled name):
# bf16 wgmma (MN-major weights), the int8 form's bf16 o-projection (K-major
# weights), wgmma on s8, fp32 on the CUDA cores
TAIL_KERNEL = "11tile_kernel"
TAIL_FORMS = {"bf16": "4BF16E", "bf16_kmajor": "7BF16_KBE", "int8": "2I8E",
              "fp32": "3F32E"}
# the tail's LN2 launch and its int8 form's row quantization
TAIL_LN_KERNEL, TAIL_QUANT_KERNEL = "9ln_kernel", "10quant_rows"
# the tail against its plain version: fp32 FMAs against cuBLAS fp32 (1e-4);
# bf16 one bf16 ulp of the O(4) outputs (0.06, rtol 2e-2), where sums in
# another order land on the other side of a rounding point
TAIL_TOL = {"float32": (1e-4, 0.0), "bfloat16": (0.06, 2e-2)}
# the tail_vs_plain cases: (model, batch) at T = 1500, tiny to turbo
TAIL_CASES = (("tiny", TAIL_CHECK_BATCH), ("base", 2), ("small", 2),
              ("medium", 1), (TURBO, 1))
# tail_time and tail_int8_time: one encoder layer of each width at b32
TAIL_TIME_MODELS = ("tiny", "small", "medium", TURBO)
# the tail's int8 form against its plain version, bf16, (atol, rtol).
# "same_attention": against the plain MLP fed the kernel's own attention
# rows. The int32 sums are exact and the GeLU is torch's formula, so only
# LN2's sums in another order (and the kernel's contracted multiply-adds)
# move a value across a bf16 rounding point; in the rows where one does
# (TAIL_Q8_ROWS_DIFFERING at most: a systematic fault would reach every
# row), h2 may move by one bf16 ulp (0.0625 at |h2| in [8, 16)) and y's and
# t1's quantization by one int8 step each, whose products add up over the
# row: 0.15, rtol 2e-2. "plain": against the whole plain version, whose
# attention sums in another order and so reaches nearly every row's
# quantization: 0.25, rtol 2e-2.
TAIL_Q8_TOL = {"same_attention": (0.15, 2e-2), "plain": (0.25, 2e-2)}
TAIL_Q8_ROWS_DIFFERING = 0.15
TAIL_Q8_CASES = (("tiny", BATCH), ("base", BATCH), ("small", 2),
                 ("medium", 1), (TURBO, 1))
# the engine's int8 phases: medium (the smallest model whose serving
# default adds the int8 self cache) and the fp32 int8-cross engine
MEDIUM_ENGINE_REQUESTS, MEDIUM_ENGINE_MAX_NEW = 16, 24   # 8 slots
Q8_ENGINE_REQUESTS, Q8_ENGINE_MAX_NEW = 16, 24           # 8 slots
# logits of the int8 encoder paths on the card against the CPU: 3% of
# the largest |logit|, the CPU tests' bound for the int8 encoders against
# JAX (tests/test_torch_int8_encoder.py)
INT8_LOGITS_REL = 0.03
# fused_phases: steps timed per model, and the models (H) at b32 bf16
FUSED_PHASE_STEPS = 20
# the pipeline layer: long-form transcription (a clip of LONGFORM_S with
# timestamps, conditioning and word timestamps, LONGFORM_MAX_NEW tokens a
# window), speculative decoding (SPEC_K drafts a round, SPEC_MAX_NEW
# tokens, EOT banned) and the CLI's long WAV (CLI_LONG_S at 22.05 kHz)
LONGFORM_S, LONGFORM_MAX_NEW = 75.0, 32
SPEC_K, SPEC_MAX_NEW = 4, 32
# the serving phases: tokens a window; benchmarks/server_load.py's mix
# (22.05 kHz clips of 5 s, every 4th client a 75 s file)
SERVE_MAX_NEW = 24
SERVE_RATE, SERVE_SHORT_S, SERVE_LONG_S, SERVE_LONG_EVERY = 22_050, 5.0, \
    75.0, 4
# the dynamic server's grace window: far wider than the spread of 8
# concurrent 30 s posts, so that they make one batch
DYNAMIC_WAIT_MS = 15_000
CLI_LONG_S, CLI_LONG_RATE = 45.0, 22_050
# the train phases: a sequence of the 4-token prompt and 220 text tokens;
# tiny's fixed batch of 16 for 6 steps at lr 1e-3 (warmup 1, total 50);
# the card-against-CPU gradients at 8 rows, where both decoder reads
# cross the 16 MiB flash gate (self 19.3 MB, cross 64.5 MB); turbo at 4
# rows for 2 steps at lr 1e-4 with no warmup (a warmup's first update has
# lr 0, and two steps must move the weights)
TRAIN_T = 224
TRAIN_TINY_BATCH, TRAIN_TINY_STEPS = 16, 6
TRAIN_PARITY_BATCH = 8
TRAIN_TURBO_BATCH, TRAIN_TURBO_STEPS = 4, 2
# card against CPU, of each leaf's largest |g|: fp32 sums in other orders
# over B*T = 1,792 positions, the tail's and flash's forwards on the card
TRAIN_GRAD_RTOL = 1e-3
# the mesh phase (parallel/): (a) turbo bf16 through ShardedPipeline on a
# world of one NCCL process, B=8, 32 greedy tokens; (b) four gloo
# processes sharing the card: turbo fp32 with tok_emb x 4 (decisive
# margins, as tests/test_sharded_inference.py:147-160), B=8, 24 tokens,
# at (dp, tp, sp) in MESH_GLOO; turbo's pipelined forwards at pp=4; tiny's
# train step at pp=4 and at (dp, tp) = (2, 2); the MoE at ep=4; a DCP
# checkpoint of tiny at tp=4 restored at tp=2 and unsharded
MESH_WORLD = 4
MESH_BATCH = 8
MESH_NCCL_TOKENS, MESH_GLOO_TOKENS = 32, 24
MESH_GLOO = ((1, 4, 1), (2, 2, 1), (2, 1, 2))        # (dp, tp, sp)
MESH_PP_T = 16                   # teacher-forced tokens of the pp decoder
MESH_LOGITS_TOL = (2e-4, 1e-5)   # (atol, rtol): fp32, sharded vs one card
MESH_ENC_TOL = (1e-4, 1e-5)      # the pp encoder (flash) vs the tail
MESH_GRAD_SHARE = 1e-4           # of the one-card gradient's largest |g|
MESH_LOSS_RTOL = 1e-4
MESH_MOE = (1280, 5120, 8, 4, 64)   # d, ff, experts, B, T
MESH_MOE_ATOL = 1e-4
MESH_TIMEOUT_S = 600
MESH_NOTE = ("the gloo ranks share one card: their walls are no measure "
             "of multi-chip scaling")
# a key bias's true gradient is 0 (the softmax cancels a constant added to
# every score): both devices must give noise there, below this share of
# the largest |g| of any leaf
KEY_BIAS_SHARE = 1e-5
KEY_BIASES = ("['encoder']['layers']['attn']['k']['b']",
              "['decoder']['layers']['attn']['k']['b']",
              "['decoder']['layers']['cross_attn']['k']['b']")
# word times on the card against the CPU: at most one encoder frame
WORD_TIME_TOL = 0.02 + 1e-9


# --only: the standalone phases (functions of the card line alone), by name
ONLY = {"tail": "tail_checks", "tail_gate": "tail_gate",
        "tail_int8": "tail_int8_checks", "tail_phases": "tail_breakdown",
        "ragged_int8": "ragged_int8_checks",
        "flash_sass": "flash_sass", "fused_checks": "fused_checks",
        "fused_time": "fused_time", "fused_phases": "fused_phases",
        "flash": "flash_checks", "decode_time": "decode_time",
        "pipeline": "pipeline_layer", "serving": "serving_group",
        "train": "train_group", "mesh": "mesh_group"}


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
    """Tail operands at cfg's width with non-zero biases and LN parameters
    (a random init's are zeros and ones). The matrices at 0.05 up to d =
    512 (tiny, base), wider at 1/sqrt(fan-in) (0.05 at tiny's 384), which
    keeps the wide layers' activations at tiny's scale, where the
    tolerances were stated."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    T, H, D, d, ff = cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim, \
        cfg.d_model, cfg.d_ff

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=g) * scale + shift).cuda()

    sd, sf = (0.05, 0.05) if d <= 512 else (d ** -0.5, ff ** -0.5)
    mats = [r(B, T, H, D), r(B, H, T, D), r(B, H, T, D), r(B, T, d),
            r(d, d, scale=sd), r(d, ff, scale=sd), r(ff, d, scale=sf)]
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


@functools.lru_cache(maxsize=None)
def _side_stream():
    """The one side stream of every warm-up before a capture: cuBLAS keeps
    a workspace for each stream it has run on, so a new stream per
    capture would leave one more resident each time."""
    import torch
    return torch.cuda.Stream()


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device ms per fn() call, captured `launches` times in one CUDA
    graph and timed over `replays` replays: the launch cost of the host
    is left out."""
    import torch
    side = _side_stream()
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


def profile_append(card: str, append_args) -> None:
    """The append's device time by replay, for PERF.md, beside the launch
    floor: the replay time of a one-element in-place add, the least one
    graph node costs on the card."""
    import torch

    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
    )

    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda: one.add_(1.0))
    for dtype, (ck, cv, kn, vn) in append_args.items():
        ms = graph_ms(lambda: cache_append_rows(ck, cv, kn, vn, 63))
        emit({"phase": "profile_append_graph", "dtype": str(dtype),
              "shape": list(ck.shape),
              "plain_ms": graph_ms(
                  lambda: cache_append_rows_plain(ck, cv, kn, vn, 63)),
              "ms": ms, "launch_floor_ms": floor_ms,
              "over_floor_us": 1e3 * (ms - floor_ms), "card": card})


def profile_build(card: str) -> None:
    """The kernels' build, in turns serial, parallel, parallel, serial,
    each from nothing into a directory of its own: serial is one nvcc over
    every source, parallel is _build.build (one nvcc per source, all at
    once, then a link)."""
    from pathlib import Path

    from whisper_tpu_torch.ops import _build
    sources = [str(p) for p in sorted(_build.CSRC.glob("*.cu"))]
    times = {"serial_s": [], "parallel_s": []}
    saved = _build.BUILD_DIR
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for kind in ("serial_s", "parallel_s", "parallel_s", "serial_s"):
                out = Path(tmp, f"{kind}{len(times[kind])}")
                out.mkdir()
                t0 = time.perf_counter()
                if kind == "serial_s":
                    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                                    "-shared", "-o", str(out / "lib.so"),
                                    *sources], capture_output=True,
                                   check=True, timeout=600)
                else:
                    _build.BUILD_DIR = out
                    _build.build()
                times[kind].append(time.perf_counter() - t0)
    finally:
        _build.BUILD_DIR = saved
    emit({"phase": "profile_build", "sources": len(sources), **times,
          "cpus": os.cpu_count(), "card": card})


def profile_path(model: str, cfg, card: str, run) -> None:
    """Five more main-path walls, the peak device memory, and one run
    under torch.profiler (device time by kernel)."""
    import torch

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

    kernels, device_ms = device_kernels(profiled(run))
    emit({"phase": "profile_device_time", "model": model,
          "device_ms": device_ms, "unprofiled_median_wall_ms": 1e3 * median,
          "device_busy_share": device_ms / (1e3 * median), "card": card})
    for e in kernels[:20]:
        emit({"phase": "profile_kernel", "model": model,
              "kernel": e.key[:120],
              "device_ms": e.self_device_time_total / 1e3,
              "count": e.count})


def main_path(pipe, kernels: dict, expect: dict, card: str,
              label: str = "main_path"):
    """The bench workload through pipe.transcribe_batch: a warm-up, then
    one run with every kernel's launch count set to 0 just before it and
    read just after it, and the peak device memory from just before it.
    Fails unless the counts equal `expect` and the output is sane. Returns
    (run, audio, bias, the phase line)."""
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
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    P = 4
    toks = res.tokens.cpu()
    gen = toks[:, P:]
    line = {"phase": label, "model": cfg.name, "dtype": cfg.compute_dtype,
            "quant": quant_flags(cfg), "batch": BATCH,
            "gen_tokens": GEN_TOKENS, "wall_s": wall,
            "audio_s_per_wall_s": BATCH * cfg.chunk_length_s / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resident_gb_before": resident, "launches": launches,
            "card": card}
    emit(line)
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
    return run, audio, bias, line


def quant_flags(cfg) -> list:
    return [f for f in ("weight_quant", "cross_kv_quant", "self_kv_quant",
                        "kv_cache_quant", "encoder_mlp_quant",
                        "encoder_qkv_quant") if getattr(cfg, f)]


@contextlib.contextmanager
def environ(env: dict):
    """os.environ with `env` set inside the block, restored after it."""
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


class EnvPipeline:
    """A pipeline whose transcribe_batch runs with `env` set (the port
    reads WHISPER_TPU_IP_CROSS at every step), so that an A/B in turns
    gives the knob to one side only."""

    def __init__(self, pipe, env: dict):
        self.pipe, self.env = pipe, env

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def transcribe_batch(self, *args, **kw):
        with environ(self.env):
            return self.pipe.transcribe_batch(*args, **kw)


def ab_walls(pipes: dict, audio, bias, order: tuple) -> dict:
    """The bench workload's wall through each pipeline in one process, in
    turns `order` (each pipeline warm first)."""
    import torch
    walls = {name: [] for name in pipes}
    for pipe in pipes.values():                 # warm-up
        pipe.transcribe_batch(audio, max_new=GEN_TOKENS - 1, logit_bias=bias)
    for name in order:
        t0 = time.perf_counter()
        pipes[name].transcribe_batch(audio, max_new=GEN_TOKENS - 1,
                                     logit_bias=bias)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    return walls


def quant_ab(pipes: dict, audio, bias, card: str) -> None:
    """The bench workload's wall under quant "off" and "auto" in one
    process, in turns off, auto, auto, off (each pipeline warm)."""
    walls = ab_walls(pipes, audio, bias, ("off", "auto", "auto", "off"))
    cfg = pipes["auto"].cfg
    emit({"phase": "quant_ab", "model": cfg.name, "dtype": cfg.compute_dtype,
          "batch": BATCH, "gen_tokens": GEN_TOKENS,
          "auto_quant": quant_flags(cfg), "off_walls_s": walls["off"],
          "auto_walls_s": walls["auto"],
          "auto_over_off": sum(walls["auto"]) / sum(walls["off"]),
          "card": card})


def on_off_ab(phase: str, pipes: dict, audio, bias, card: str) -> None:
    """The bench workload's wall with an option off and on in one process,
    in turns off, on, on, off (each pipeline warm): the fused step
    (fused_ab), attn_backend "pallas" with WHISPER_TPU_IP_CROSS=bg8
    (bg_ab)."""
    walls = ab_walls(pipes, audio, bias, ("off", "on", "on", "off"))
    cfg = pipes["on"].cfg
    emit({"phase": phase, "model": cfg.name, "dtype": cfg.compute_dtype,
          "batch": BATCH, "gen_tokens": GEN_TOKENS,
          "off_walls_s": walls["off"], "on_walls_s": walls["on"],
          "on_over_off": sum(walls["on"]) / sum(walls["off"]),
          "card": card})


def main_path_stages(pipe, audio, bias, card: str) -> None:
    """Where the main path's time and memory go: per stage, the host clock
    between two synchronisations and the peak device memory from its
    start."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_loop, _greedy_prefill, encode
    P, max_new = 4, GEN_TOKENS - 1
    stages, peaks = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name + "_s"] = time.perf_counter() - t
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        return out

    mel = stage("mel", lambda: log_mel_spectrogram(
        torch.from_numpy(audio).cuda(), pipe.cfg))
    enc = stage("encoder", lambda: encode(pipe.params, pipe.cfg, mel))
    with torch.inference_mode():
        prompt = pipe.prompt(BATCH)
        pre = stage("prefill", lambda: _greedy_prefill(
            pipe.params, pipe.cfg, enc, prompt, P + GEN_TOKENS))
        stage("loop", lambda: _greedy_loop(pipe.params, pipe.cfg, *pre,
                                           prompt, bias, max_new))
    stages["loop_ms_per_step"] = 1e3 * stages["loop_s"] / max_new
    emit({"phase": "main_path_stages", "model": pipe.cfg.name,
          "dtype": pipe.cfg.compute_dtype, "quant": quant_flags(pipe.cfg),
          "fused_step": bool(pipe.cfg.fused_step),
          **stages, "peak_gb": peaks, "card": card})


def fp32_parity(model: str, params, clips: np.ndarray, max_new: int,
                bf16_tokens, vocab_path=None, logit_atol: float = 1e-3
                ) -> dict:
    """fp32 on the card against the CPU's plain versions, from the same
    params: tokens, prefill logits and encoder output. Fails unless the
    tokens are identical and the logits agree to `logit_atol`."""
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
                                          vocab_path=vocab_path, quant="off")
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
        runs["cfg"] = p32.cfg
        del p32, wav, enc, logits, res
        torch.cuda.empty_cache()
    same_tokens = bool(torch.equal(runs["gpu"][0], runs["cpu"][0]))
    logit_err = float((runs["gpu"][1] - runs["cpu"][1]).abs().max())
    enc_err = float((runs["gpu"][2] - runs["cpu"][2]).abs().max())
    agree16 = float((bf16_tokens[:, P:] == runs["gpu"][0][:, P:]
                     ).float().mean())
    name = getattr(model, "name", model)
    out = {"model": name, "quant": quant_flags(runs["cfg"]),
           "batch": len(clips), "max_new": max_new,
           "tokens_identical": same_tokens, "tokens": runs["gpu"][0].tolist(),
           "prefill_logits_max_abs_err": logit_err,
           "encoder_max_abs_err": enc_err,
           "bf16_token_agreement_with_fp32": agree16,
           "gpu_s": runs["gpu"][3], "cpu_s": runs["cpu"][3]}
    require(same_tokens, f"{name}: fp32 tokens differ between GPU and CPU")
    # 1e-3: fp32 logits of order 10, GPU kernels against CPU torch summing
    # in other orders (TF32 would miss this by ~100x)
    out["logit_atol"] = logit_atol
    require(logit_err < logit_atol,
            f"{name}: fp32 prefill logits differ by {logit_err}")
    return out


def composed_tail(q, k, v, h, wo, fc1, fc2, o_b, fc1_b, fc2_b, g, b,
                  eps: float = 1e-5):
    """The tail composed from library calls in the compute dtype: SDPA,
    three torch.matmul and torch epilogues. A yardstick of speed only (its
    rounding points are not the kernel's); the port never calls it."""
    import torch.nn.functional as F
    B, T, H, D = q.shape
    dt = h.dtype
    a = F.scaled_dot_product_attention(q.transpose(1, 2), k, v)
    a = a.transpose(1, 2).reshape(B, T, H * D)
    h2 = h + (a @ wo + o_b.to(dt))
    y = F.layer_norm(h2.float(), (h2.shape[-1],), g, b, eps).to(dt)
    t = F.gelu(y @ fc1 + fc1_b.to(dt))
    return h2 + (t @ fc2 + fc2_b.to(dt))


def tail_checks(card: str) -> dict:
    """tail_vs_plain: the kernel against its plain version at tiny (B=4),
    base (B=2), small (B=2), medium and turbo (B=1) widths, T = 1500, fp32
    and bf16, and at b32. tail_time at tiny, small, medium and turbo b32:
    bf16 and fp32, each in turns against its plain version and against the
    tail composed from SDPA, three matmuls and torch epilogues
    (composed_tail), beside the bf16 bound (on the bf16 peak) and the fp32
    bound (on the fp32 peak). Returns the kernels-line numbers (tiny b32
    bf16, the other widths' beside them)."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_plain,
    )
    for model, B in TAIL_CASES:
        mcfg = get_config(model)
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = TAIL_TOL[str(dtype).split(".")[1]]
            args = tail_inputs(mcfg, B, dtype, seed=1)
            got = encoder_block_tail(*args).float()
            want = encoder_block_tail_plain(*args).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= atol + rtol * want.abs()).all())
            emit({"phase": "tail_vs_plain", "model": model,
                  "dtype": str(dtype),
                  "shape": [B, mcfg.n_audio_ctx, mcfg.n_heads,
                            mcfg.head_dim], "d": mcfg.d_model,
                  "ff": mcfg.d_ff, "max_abs_err": float(err.max()),
                  "atol": atol, "rtol": rtol, "ok": ok})
            require(ok, f"encoder_block_tail {model} {dtype} disagrees with "
                        f"its plain version (max abs err {float(err.max())})")
            del args, got, want, err
    out = {}
    for model in TAIL_TIME_MODELS:
        cfg = get_config(model)
        B, T, H, D = BATCH, cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim
        d, ff = cfg.d_model, cfg.d_ff
        flops = (4 * B * H * T * T * D + 2 * B * T * d * d
                 + 4 * B * T * d * ff)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            atol, rtol = TAIL_TOL[name]
            e = dtype.itemsize
            args = tail_inputs(cfg, BATCH, dtype, seed=2)
            got = encoder_block_tail(*args).float()
            want = encoder_block_tail_plain(*args).float()
            err = (got - want).abs()
            max_err = float(err.max())
            require(bool((err <= atol + rtol * want.abs()).all()),
                    f"encoder_block_tail {model} b32 {name} max abs err "
                    f"{max_err}")
            del got, want, err
            ms, plain_ms = alternate_ms(
                lambda: encoder_block_tail_plain(*args),
                lambda: encoder_block_tail(*args), 5)
            ms2, composed_ms = alternate_ms(
                lambda: composed_tail(*args),
                lambda: encoder_block_tail(*args), 5)
            # q, k, v, h in and h out, the three matrices, the five fp32
            # vectors
            moved = (5 * B * T * d * e + (d * d + 2 * d * ff) * e
                     + (4 * d + ff) * 4)
            line = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                    **bound(moved, flops, "bfloat16"), "library_ms": None}
            emit({"phase": "tail_time", "model": model,
                  "shape": [B, T, H, D], "d": d, "ff": ff, "dtype": name,
                  **line, "ms_beside_composed": ms2,
                  "composed_context_ms": composed_ms,
                  "fp32_bound_ms": bound(moved, flops, "float32")["bound_ms"],
                  "tflops": flops / (ms * 1e9), "card": card})
            if dtype == torch.bfloat16:
                if model == "tiny":
                    out = line
                else:
                    out[model + "_b32"] = line
            del args
            torch.cuda.empty_cache()
    return out


def tail_gate(card: str) -> None:
    """The encoder's gate (ops/encoder_layer.py tail_fits_smem) against
    the kernel's own answer at every width of the family: the tail kernel
    must run where the gate says it fits and refuse where it does not."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_q8,
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
        smem = tail_smem_bytes(cfg.d_model, cfg.d_ff)
        smem8 = tail_smem_bytes(cfg.d_model, cfg.d_ff, q8=True)
        lib = _build.load_library()
        require(smem == lib.wt_encoder_tail_smem(cfg.d_model, cfg.d_ff, 0)
                and smem8 == lib.wt_encoder_tail_smem(cfg.d_model,
                                                      cfg.d_ff, 1),
                f"tail_gate: {name}'s shared memory differs between "
                f"ops/encoder_layer.py and the kernel")
        fits8 = tail_fits_smem(cfg.d_model, cfg.d_ff, dev, q8=True)
        try:
            encoder_block_tail_q8(*tail_q8_inputs(cfg, 1, seed=4, o_q=True))
            torch.cuda.synchronize()
            runs8 = True
        except ValueError:              # the wrapper's refusal: d > 1280
            runs8 = False
        rows.append({"model": name, "d": cfg.d_model, "smem_bytes": smem,
                     "gate_fits": fits, "kernel_runs": runs,
                     "int8_smem_bytes": smem8, "int8_gate_fits": fits8,
                     "int8_kernel_runs": runs8})
        del args
    ok = all(r["gate_fits"] == r["kernel_runs"]
             and r["int8_gate_fits"] == r["int8_kernel_runs"] for r in rows)
    emit({"phase": "tail_gate", "smem_optin": torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin, "widths": rows, "ok": ok,
          "card": card})
    require(ok, "the tail gate disagrees with the tail kernel")
    for key in ("gate_fits", "int8_gate_fits"):
        require([r[key] for r in rows] == [True] * 5,
                f"every width from tiny to turbo must take the tail ({key})")


def tail_q8_inputs(cfg, B: int, seed: int, o_q: bool):
    """The int8 form's operands at cfg's width: tail_inputs in bf16, fc1
    and fc2 (and wo under o_q, else wo in bf16) quantized per output
    column as the encoder quantizes them, K-major."""
    import torch

    from whisper_tpu_torch.models.whisper import _quant_cols
    q, k, v, h, wo, fc1, fc2, *vecs = tail_inputs(cfg, B, torch.bfloat16,
                                                  seed)
    f1q, f1s = _quant_cols(fc1)
    f2q, f2s = _quant_cols(fc2)
    wo_s = None
    if o_q:
        wo, wo_s = _quant_cols(wo)
    return [q, k, v, h, wo.t().contiguous(), f1q.t().contiguous(),
            f2q.t().contiguous(), *vecs, f1s, f2s, wo_s]


def composed_tail_q8(q, k, v, h, wo_t, fc1_t, fc2_t, o_b, fc1_b, fc2_b, g, b,
                     fc1_s, fc2_s, wo_s, eps: float = 1e-5):
    """The int8 form composed from library calls: SDPA, then per product a
    torch row quantization, torch._int_mm and its rescale, and torch
    epilogues. A yardstick of speed only (its rounding points are not the
    kernel's); the port never calls it."""
    import torch
    import torch.nn.functional as F
    B, T, H, D = q.shape
    dt = h.dtype

    def q8mm(x, w_t, w_s):
        x2 = x.float().reshape(-1, x.shape[-1])
        sx = (x2.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-10)
        xq = (x2 / sx).round().clamp(-127, 127).to(torch.int8)
        y = torch._int_mm(xq, w_t.t()).float() * (sx * w_s)
        return y.to(dt).reshape(*x.shape[:-1], -1)

    a = F.scaled_dot_product_attention(q.transpose(1, 2), k, v)
    a = a.transpose(1, 2).reshape(B, T, H * D)
    o = q8mm(a, wo_t, wo_s) if wo_s is not None else a @ wo_t.t()
    h2 = h + (o + o_b.to(dt))
    y = F.layer_norm(h2.float(), (h2.shape[-1],), g, b, eps).to(dt)
    t = F.gelu(q8mm(y, fc1_t, fc1_s) + fc1_b.to(dt))
    return h2 + (q8mm(t, fc2_t, fc2_s) + fc2_b.to(dt))


def tail_q8_bound(B: int, T: int, H: int, D: int, d: int, ff: int) -> dict:
    """The int8 form's bound: its bytes (q, k, v, h in and the output in
    bf16, the int8 matrices, the fp32 vectors and scales) over the memory
    rate, against its operations: the attention's bf16 FLOP at the bf16
    peak plus the o-projection's and the MLP's int8 operations at the int8
    peak."""
    moved = 5 * B * T * d * 2 + (d * d + 2 * d * ff) + (6 * d + 2 * ff) * 4
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = (4 * B * H * T * T * D / H100_FLOPS["bfloat16"]
             + 2 * B * T * (d * d + 2 * d * ff) / H100_INT8_OPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tail_int8_checks(card: str) -> dict:
    """tail_int8_vs_plain: the int8 form's kernel (encoder_block_tail_q8)
    at tiny b32, base b32, small (B=2), medium and turbo (B=1), with the
    int8 o-projection and without it (WHISPER_TPU_ENC_I8O=0): against the
    plain MLP fed the kernel's own attention rows (tail_q8_mlp after the
    flash kernel) and against the whole plain version, at TAIL_Q8_TOL.
    tail_int8_time at tiny, small, medium and turbo b32 (the encoder's
    form, o_q): the kernel in turns against its plain version, beside the
    bf16 tail kernel at the same shape, the composed library calls
    (composed_tail_q8) and the bound. Returns the kernels-line numbers
    (tiny, the other widths' beside)."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_q8,
        encoder_block_tail_q8_plain,
        tail_q8_mlp,
    )
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    max_err = 0.0
    for model, B in TAIL_Q8_CASES:
        mcfg = get_config(model)
        for o_q in (True, False):
            args = tail_q8_inputs(mcfg, B, seed=1, o_q=o_q)
            got = encoder_block_tail_q8(*args).float()
            att = flash_attention(args[0], args[1], args[2])
            same = tail_q8_mlp(att.reshape(args[3].shape), *args[3:]).float()
            del att
            line = {"phase": "tail_int8_vs_plain", "model": model,
                    "batch": B, "o_q": o_q, "d": mcfg.d_model,
                    "ff": mcfg.d_ff, "card": card}
            for name, want in (("same_attention", same), ("plain", None)):
                if want is None:
                    want = encoder_block_tail_q8_plain(*args).float()
                atol, rtol = TAIL_Q8_TOL[name]
                err = (got - want).abs()
                rows = err.reshape(-1, mcfg.d_model).amax(-1) > 0
                line[name] = {
                    "max_abs_err": float(err.max()), "atol": atol,
                    "rtol": rtol,
                    "ok": bool((err <= atol + rtol * want.abs()).all()),
                    "rows_differing": float(rows.float().mean())}
                del want, err
            torch.cuda.synchronize()
            emit(line)
            for name in TAIL_Q8_TOL:
                require(line[name]["ok"],
                        f"encoder_block_tail_q8 {model} o_q={o_q} disagrees "
                        f"with its plain version ({name}: "
                        f"{line[name]['max_abs_err']})")
            require(line["same_attention"]["rows_differing"]
                    <= TAIL_Q8_ROWS_DIFFERING,
                    f"encoder_block_tail_q8 {model} o_q={o_q}: "
                    f"{line['same_attention']['rows_differing']:.3f} of the "
                    f"rows differ from the plain MLP on the same attention")
            max_err = max(max_err, line["plain"]["max_abs_err"])
            del args, got, same
            torch.cuda.empty_cache()
    out = {}
    for model in TAIL_TIME_MODELS:
        cfg = get_config(model)
        B, T, H, D = BATCH, cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim
        args = tail_q8_inputs(cfg, B, seed=2, o_q=True)
        ms, plain_ms = alternate_ms(
            lambda: encoder_block_tail_q8_plain(*args),
            lambda: encoder_block_tail_q8(*args), 5)
        ms2, composed_ms = alternate_ms(lambda: composed_tail_q8(*args),
                                        lambda: encoder_block_tail_q8(*args),
                                        5)
        bargs = tail_inputs(cfg, B, torch.bfloat16, seed=2)
        bf16_ms = cuda_ms(lambda: encoder_block_tail(*bargs), 5)
        line = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                **tail_q8_bound(B, T, H, D, cfg.d_model, cfg.d_ff),
                "library_ms": None}
        emit({"phase": "tail_int8_time", "model": model,
              "shape": [B, T, H, D], "d": cfg.d_model, "ff": cfg.d_ff,
              **line, "ms_beside_composed": ms2,
              "composed_context_ms": composed_ms, "bf16_tail_ms": bf16_ms,
              "card": card})
        if model == "tiny":
            out = line
        else:
            out[model + "_b32"] = line
        del args, bargs
        torch.cuda.empty_cache()
    return out


def tail_breakdown(card: str) -> None:
    """tail_phases: the tail's launches at turbo b32 by kernel, device time
    under torch.profiler over three calls: the flash attention, the MLP
    tiles (O_PROJ, FC1, FC2), LN2 and the int8 form's row quantizations,
    in bf16, fp32 and the int8 form (o_q)."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_q8,
    )
    cfg = get_config(TURBO)
    for form in ("bfloat16", "float32", "int8"):
        if form == "int8":
            fn, args = encoder_block_tail_q8, tail_q8_inputs(cfg, BATCH, 2,
                                                             True)
        else:
            fn, args = encoder_block_tail, tail_inputs(
                cfg, BATCH, getattr(torch, form), seed=2)
        fn(*args)
        torch.cuda.synchronize()

        def run():
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        kernels, device_ms = device_kernels(profiled(run))
        emit({"phase": "tail_phases", "model": TURBO, "batch": BATCH,
              "form": form, "device_ms_per_call": device_ms / 3,
              "kernels": [{"kernel": e.key[:110],
                           "ms_per_call": e.self_device_time_total / 3e3,
                           "count": e.count} for e in kernels[:8]],
              "card": card})
        del args
        torch.cuda.empty_cache()


def ragged_int8_checks(card: str) -> dict:
    """ragged_int8_vs_plain: the ragged append on int8 caches at the tiny
    engine's shape and the medium engine's (the main path's int8 self
    cache), exact and in place, one row outside [0, S) untouched; then
    ragged_int8_time at tiny's shape by CUDA-graph replay: the kernel, its
    plain version, the indexed assignment (the library call) and the
    launch floor (a one-element add). Returns the kernels-line numbers."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows_ragged,
        cache_append_rows_ragged_plain,
    )
    g = torch.Generator(device="cpu").manual_seed(11)
    m = get_config("medium")
    shapes = {"tiny": RAGGED_SHAPES["tiny"],
              "medium": (m.n_text_layers, 8, m.n_heads, m.n_text_ctx,
                         m.head_dim)}

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).cuda()

    for name, shape in shapes.items():
        L, B, H, S, D = shape
        ck, cv, kn, vn = (ints(shape), ints(shape), ints((L, B, H, D)),
                          ints((L, B, H, D)))
        pos = torch.from_numpy(ragged_positions(B, S, B, S)).cuda()
        before = (ck[:, -1].clone(), cv[:, -1].clone())
        want_k, want_v = cache_append_rows_ragged_plain(
            ck.clone(), cv.clone(), kn, vn, pos)
        ptrs = (ck.data_ptr(), cv.data_ptr())
        got_k, got_v = cache_append_rows_ragged(ck, cv, kn, vn, pos)
        torch.cuda.synchronize()
        in_place = (got_k.data_ptr(), got_v.data_ptr()) == ptrs
        exact = bool(torch.equal(got_k, want_k) and torch.equal(got_v, want_v))
        untouched = bool(torch.equal(got_k[:, -1], before[0])
                         and torch.equal(got_v[:, -1], before[1]))
        emit({"phase": "ragged_int8_vs_plain", "engine": name,
              "shape": list(shape), "exact": exact, "in_place": in_place,
              "outside_row_untouched": untouched})
        require(exact and in_place and untouched,
                f"cache_append_rows_ragged int8 {name}: exact={exact} "
                f"in_place={in_place} untouched={untouched}")
        del ck, cv, kn, vn, want_k, want_v, before
    L, B, H, S, D = shape = shapes["tiny"]
    ck, cv, kn, vn = (ints(shape), ints(shape), ints((L, B, H, D)),
                      ints((L, B, H, D)))
    pos = torch.from_numpy(ragged_positions(B, S, 7)).cuda()
    rows = torch.arange(B, device="cuda")
    one = torch.zeros(1, device="cuda")

    def library():      # the JAX fallback's indexed assignment, per cache
        ck[:, rows, :, pos, :] = kn.transpose(0, 1)
        cv[:, rows, :, pos, :] = vn.transpose(0, 1)

    graphs = {n: graph_ms(fn) for n, fn in (
        ("ms", lambda: cache_append_rows_ragged(ck, cv, kn, vn, pos)),
        ("plain_ms", lambda: cache_append_rows_ragged_plain(ck, cv, kn, vn,
                                                            pos)),
        ("library_ms", library), ("launch_floor_ms", lambda: one.add_(1.0)))}
    moved = 2 * 2 * kn.numel() + pos.numel() * 8
    out = {"max_abs_err": 0.0, "ms": graphs["ms"],
           "plain_ms": graphs["plain_ms"], "library_ms": graphs["library_ms"],
           **bound(moved, 0, "bfloat16")}
    emit({"phase": "ragged_int8_time", "shape": list(shape), "dtype": "int8",
          **out, "launch_floor_ms": graphs["launch_floor_ms"],
          "timing": "CUDA-graph replay, 100 launches a graph",
          "card": card})
    return out


def flash_checks(card: str, profile: bool = False) -> dict:
    """The flash kernel against its plain version at the shapes the port
    gives it: turbo's (H=20, D=64) in the greedy path, and every read that
    the engines' fills route to it (tiny's 32 slots at H=6, turbo's 8 at
    H=20: the prefill's cross reads at p_pad 32 and 128, turbo's encoder
    over 8 slots on views of the fused QKV). Then the FLASH_TIME shapes
    in bf16 and FLASH_TIME_FP32's in fp32, timed against the plain version
    and SDPA (with `profile`, SDPA's fp32 kernels by name). Returns the
    kernels-line numbers (bf16 b32, fp32 beside them)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.models.whisper import split_heads, split_heads_hm
    from whisper_tpu_torch.ops.attention import _route
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    H, D = 20, 64
    # B, T, H, S, kv_len, q_offset, causal, and for the engines' fills the
    # read (each one the gate sends to flash)
    cases = {
        "a_encoder": (4, 1500, H, 1500, None, 0, False, None),
        "b_cross_prefill": (32, 4, H, 1500, None, 0, False, None),
        "c_causal_prefill": (32, 4, H, 128, 4, 0, True, None),
        "d_causal_offset": (32, 40, H, 448, 140, 100, True, None),
        "e_kv_len_0": (4, 4, H, 128, 0, 0, False, None),
        "f_tiny_fill_cross_p32": (BATCH, 32, 6, 1500, None, 0, False,
                                  "cross"),
        "g_tiny_fill_cross_p128": (BATCH, 128, 6, 1500, None, 0, False,
                                   "cross"),
        "h_turbo_fill_cross_p32": (8, 32, H, 1500, None, 0, False, "cross"),
        "i_turbo_fill_cross_p128": (8, 128, H, 1500, None, 0, False,
                                    "cross"),
        "j_turbo_fill_encoder": (8, 1500, H, 1500, None, 0, False,
                                 "encoder"),
    }
    g = torch.Generator(device="cpu").manual_seed(5)

    def inputs(B, T, H, S, dtype, fused=False):
        if fused:       # the encoder's q, k, v: views of one QKV product
            qkv = torch.randn((B, T, 3 * H * D), generator=g).to("cuda",
                                                                 dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            return split_heads(q, H), split_heads_hm(k, H), \
                split_heads_hm(v, H)
        return [torch.randn(s, generator=g).to("cuda", dtype)
                for s in ((B, T, H, D), (B, H, S, D), (B, H, S, D))]

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = FLASH_TOL[str(dtype).split(".")[1]]
        for name, (B, T, Hc, S, kv_len, q_offset, causal, fill
                   ) in cases.items():
            q, k, v = inputs(B, T, Hc, S, dtype, fused=fill == "encoder")
            require(fill is None or _route(q, k) == "flash",
                    f"flash case {name}: the gate does not send it to flash")
            got = flash_attention(q, k, v, kv_len, q_offset, causal=causal)
            want = flash_attention_plain(q, k, v, kv_len, q_offset,
                                         causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if kv_len == 0:
                ok = ok and not bool(got.any())
            line = {"phase": "flash_vs_plain", "case": name,
                    "dtype": str(dtype), "shape": [B, T, Hc, D], "S": S,
                    "kv_len": kv_len, "q_offset": q_offset, "causal": causal,
                    "fill": fill, "max_abs_err": float(err.max()),
                    "atol": atol, "rtol": rtol, "ok": ok}
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

    # the bf16 shapes of the main paths, each timed in turns against the
    # plain version, beside its bound and SDPA; fp32 at turbo's and tiny's
    # layers. Each is also timed by replay against SDPA by replay (fewer
    # launches a graph at T = 1500).
    shapes = {}
    for dtype, name in [(torch.bfloat16, n) for n in FLASH_TIME] + [
            (torch.float32, n) for n in FLASH_TIME_FP32]:
        atol, rtol = FLASH_TOL[str(dtype).split(".")[1]]
        B, T, Hc, S = FLASH_TIME[name]
        q, k, v = inputs(B, T, Hc, S, dtype)
        got = flash_attention(q, k, v).float()
        want = flash_attention_plain(q, k, v).float()
        err = (got - want).abs()
        max_err = float(err.max())
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"flash_attention {name} {dtype} max abs err {max_err}")
        del got, want, err
        iters = 5 if T == 1500 else 50
        ms, plain_ms = alternate_ms(lambda: flash_attention_plain(q, k, v),
                                    lambda: flash_attention(q, k, v),
                                    iters=iters)

        # library_time: the one PyTorch call for the same function, on the
        # same q, k, v, with q's transpose to (B, H, T, D) in the timed
        # call. A yardstick only: the port never calls it.
        def sdpa():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k, v)

        library_ms = cuda_ms(sdpa, iters=iters)
        flops = 4 * B * Hc * T * S * D
        line = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                **bound(2 * (B * T + B * S) * Hc * D * q.element_size(),
                        flops, str(dtype).split(".")[1])}
        if T < 1500 or dtype == torch.float32:
            n = (100, 20) if T < 1500 else (5, 4)
            line["graph_ms"] = graph_ms(lambda: flash_attention(q, k, v), *n)
            line["library_graph_ms"] = graph_ms(sdpa, *n)
        emit({"phase": "flash_time", "case": name, "shape": [B, T, Hc, D],
              "S": S, "dtype": str(dtype), **line,
              "tf32": torch.backends.cuda.matmul.allow_tf32,
              "tflops": flops / (ms * 1e9), "card": card})
        # the main paths' dtype, bf16; fp32 (the parity mode) beside it
        shapes[name if dtype == torch.bfloat16 else f"{name}_fp32"] = line
        if profile and dtype == torch.float32 and name == "turbo_layer":
            sdpa_kernels(sdpa, card)
        del q, k, v
        torch.cuda.empty_cache()
    # the kernels line: turbo's b32 layer, and every timed bf16 shape
    return {**shapes["turbo_layer"], "shapes": shapes}


def sdpa_kernels(sdpa, card: str) -> None:
    """flash_sdpa_kernels: the device kernels of one SDPA call (the fp32
    yardstick, TF32 off) by name, from torch.profiler."""
    import torch
    sdpa()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    kernels, device_ms = device_kernels(prof)
    emit({"phase": "flash_sdpa_kernels", "dtype": "torch.float32",
          "kernels": [{"kernel": e.key[:160],
                       "device_ms": e.self_device_time_total / 1e3,
                       "count": e.count} for e in kernels[:5]],
          "device_ms": device_ms, "card": card})


def sass_counts(sass: str, symbol: str, opcodes: tuple) -> dict:
    """{function: {opcode: count}} over the SASS functions whose name
    holds `symbol`."""
    counts, fn = {}, None
    for text in sass.splitlines():
        if "Function : " in text:
            fn = text.split("Function : ")[1].strip()
            fn = fn if symbol in fn else None
            if fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn:
            # "/*0010*/  @P0 FFMA R2, R3, R4, R2 ;  /* encoding */"
            ops = [t for t in text.split("*/", 1)[-1].split(";")[0].split()
                   if not t.startswith("@")]
            op = ops[0].split(".")[0] if ops else ""
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def ptxas_lines(log: str, symbol: str) -> tuple[dict, dict]:
    """({function: registers line}, {function: spills line}) from the
    -Xptxas -v log for the functions whose name holds `symbol`."""
    ptxas, fn = {}, None
    for text in log.splitlines():
        if "Compiling entry function" in text:
            fn = text.split("'")[1] if symbol in text else None
        elif fn:
            ptxas.setdefault(fn, []).append(text.strip())
    regs = {f: next((t for t in lines if "registers" in t), None)
            for f, lines in ptxas.items()}
    spills = {f: next((t for t in lines if "spill" in t), None)
              for f, lines in ptxas.items()}
    return regs, spills


def flash_sass(card: str) -> None:
    """The flash kernels as built. bf16: its HGMMA (wgmma) instructions in
    the library's SASS, and what -Xptxas -v reported for it (registers,
    spills, any wgmma serialization). fp32: its FFMA count, and no tensor-
    core instruction (HMMA, HGMMA): the parity mode's products stay on the
    CUDA cores."""
    from whisper_tpu_torch.ops import _build
    so, _, log = _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hgmma = {f: c["HGMMA"] for f, c in sass_counts(
        sass, FLASH_BF16_KERNEL, ("HGMMA",)).items()}
    regs, spills = ptxas_lines(log, FLASH_BF16_KERNEL)
    serialized = [t for t in log.splitlines()
                  if "wgmma" in t and "serialized" in t]
    emit({"phase": "flash_sass", "dtype": "torch.bfloat16", "hgmma": hgmma,
          "registers": regs, "spills": spills,
          "wgmma_serialized": serialized, "card": card})
    require(len(hgmma) == 2 and all(n > 0 for n in hgmma.values()),
            f"flash_sass: the bf16 flash kernels run no HGMMA ({hgmma})")
    fp32 = sass_counts(sass, FLASH_FP32_KERNEL,
                       ("FFMA", "HMMA", "HGMMA", "LDS", "MUFU"))
    regs, spills = ptxas_lines(log, FLASH_FP32_KERNEL)
    emit({"phase": "flash_sass", "dtype": "torch.float32", "counts": fp32,
          "registers": regs, "spills": spills, "card": card})
    require(len(fp32) == 2 and all(
        c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0
        for c in fp32.values()),
            f"flash_sass: the fp32 flash kernels must run FFMA and no "
            f"tensor-core instruction ({fp32})")
    # the tail's MLP tiles: wgmma in bf16 and int8; in fp32 FFMA and no
    # tensor-core instruction; none spills. The fused step's kernels as
    # built.
    ops = ("FFMA", "HMMA", "HGMMA", "IGMMA", "IMMA", "LDS", "MUFU")
    for label, symbol in (*(("tail_mlp_" + f, (TAIL_KERNEL, frag))
                            for f, frag in TAIL_FORMS.items()),
                          ("tail_ln2", TAIL_LN_KERNEL),
                          ("tail_quant_rows", TAIL_QUANT_KERNEL),
                          ("fused_step", FUSED_KERNEL)):
        frag = None
        if isinstance(symbol, tuple):
            symbol, frag = symbol
        counts = {f: c for f, c in sass_counts(sass, symbol, ops).items()
                  if frag is None or frag in f}
        regs, spills = ptxas_lines(log, symbol)
        regs = {f: t for f, t in regs.items() if frag is None or frag in f}
        spills = {f: t for f, t in spills.items()
                  if frag is None or frag in f}
        spilled = {f: spill_bytes(t) for f, t in spills.items()}
        emit({"phase": "flash_sass", "kernel": label, "symbol": symbol,
              "form": frag, "counts": counts, "registers": regs,
              "spills": spills, "card": card})
        require(len(counts) > 0 and all(n == 0 for n in spilled.values()),
                f"flash_sass: {symbol} missing or spilling ({spilled})")
        if frag in (TAIL_FORMS["bf16"], TAIL_FORMS["bf16_kmajor"]):
            require(all(c["HGMMA"] > 0 for c in counts.values()),
                    f"flash_sass: the bf16 tail MLP runs no HGMMA ({counts})")
        elif frag == TAIL_FORMS["int8"]:
            require(all(c["HGMMA"] + c["IGMMA"] > 0 for c in counts.values()),
                    f"flash_sass: the int8 tail MLP runs no wgmma ({counts})")
        elif frag == TAIL_FORMS["fp32"]:
            require(all(c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0
                        for c in counts.values()),
                    f"flash_sass: the fp32 tail MLP must run FFMA and no "
                    f"tensor-core instruction ({counts})")


def spill_bytes(line) -> int:
    """Spill stores plus loads of a ptxas "N bytes spill stores, M bytes
    spill loads" line (0 when the line is missing)."""
    words = (line or "").replace(",", " ").split()
    return sum(int(words[i - 2]) for i, w in enumerate(words)
               if w == "spill" and i >= 2 and words[i - 1] == "bytes")


def bound(bytes_moved: float, flops: float, dtype: str) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over the peak rate of their type. Published
    NVIDIA H100 SXM peaks at 700 W, dense: 3.35 TB/s; 989 TFLOP/s bf16 on
    the tensor cores, 67 TFLOP/s fp32 outside them."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fused_inputs(B: int, L: int, H: int, dtype, seed: int):
    """fused_decoder_step operands at width H*64 (ff = 4d), made on the
    card from a seed: h0, the packed decoder (weights scaled by
    1/sqrt(fan-in); non-trivial biases and LayerNorm vectors, bf16-valued
    in bf16 as the live params are), a 448-slot self cache and 1500 cross
    positions."""
    import torch

    from whisper_tpu_torch.ops.decoder_step import PackedDecoder, vec_offsets
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, ff = 64 * H, 256 * H

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    off = vec_offsets(d, ff)
    vec = torch.randn((L, off["end"]), generator=g, device="cuda") * 0.1
    for name in ("ln1_g", "ln2_g", "ln3_g"):
        vec[:, off[name]:off[name] + d] += 1.0
    packed = PackedDecoder(
        wqkv=r(L, d, 3 * d, scale=d ** -0.5), wcq=r(L, d, d, scale=d ** -0.5),
        wo=r(L, d, d, scale=d ** -0.5), wco=r(L, d, d, scale=d ** -0.5),
        fc1=r(L, d, ff, scale=d ** -0.5), fc2=r(L, ff, d, scale=ff ** -0.5),
        vec=vec.to(dtype).float())
    return (r(B, d), packed, r(L, B, H, 448, 64), r(L, B, H, 448, 64),
            r(L, B, H, 1500, 64), r(L, B, H, 1500, 64))


def fused_layers(args, L: int):
    """The first L layers of fused_inputs' operands (contiguous views)."""
    from whisper_tpu_torch.ops.decoder_step import PackedDecoder
    h0, packed, *caches = args
    return (h0, PackedDecoder(*(t[:L] for t in packed)),
            *(c[:L] for c in caches))


def fused_checks(card: str) -> float:
    """fused_vs_plain: the kernel against its plain version at tiny b32
    (4 layers), turbo b32 (one layer and four), tiny B = 1, 3 and 33 and
    turbo B = 1 (one layer), fp32 and bf16, at pos 0, 4, 48 and 447 of the
    448-slot cache; the largest error on h_out, k_new and v_new per case,
    and a second call on the same inputs bitwise equal to the first. The
    tolerance is held against the plain version, and against its
    fp64-summed form only where the plain version is off that form
    (fused_close; such elements are counted). Returns the largest error of
    the main path's case (tiny b32 bf16)."""
    import torch

    from whisper_tpu_torch.ops.decoder_step import (
        fused_decoder_step,
        fused_decoder_step_plain,
    )
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = FUSED_TOL[str(dtype).split(".")[1]]
        for model, H, B, depths in (("tiny", 6, BATCH, (4,)),
                                    ("turbo", 20, BATCH, (1, 4)),
                                    ("tiny", 6, 1, (4,)), ("tiny", 6, 3, (4,)),
                                    ("tiny", 6, 33, (4,)),
                                    ("turbo", 20, 1, (1,))):
            full = fused_inputs(B, 4, H, dtype, seed=B + H)
            for L in depths:
                args = fused_layers(full, L)
                for pos in FUSED_POS:
                    got = fused_decoder_step(*args, pos + 1, n_heads=H)
                    again = fused_decoder_step(*args, pos + 1, n_heads=H)
                    want = fused_decoder_step_plain(*args, pos + 1, n_heads=H)
                    exact = fused_decoder_step_plain(
                        *args, pos + 1, n_heads=H, acc_dtype=torch.float64)
                    torch.cuda.synchronize()
                    # a fixed order of every sum: two calls bitwise equal
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    errs, ok, flips = {}, same, 0
                    for name, a, b, c in zip(("h_out", "k_new", "v_new"), got,
                                             want, exact):
                        e = (a.float() - b.float()).abs()
                        errs[name] = float(e.max())
                        close = fused_close(a, b, c, atol, rtol)
                        ok = ok and bool(close.all())
                        flips += int((close & ~within(a, b, atol, rtol)).sum())
                    if (model, B, dtype) == ("tiny", BATCH, torch.bfloat16):
                        main_err = max(main_err, *errs.values())
                    emit({"phase": "fused_vs_plain", "model": model,
                          "dtype": str(dtype), "batch": B, "layers": L,
                          "heads": H, "pos": pos, "max_abs_err": errs,
                          "atol": atol, "rtol": rtol,
                          "plain_fp32_near_ties": flips,
                          "repeat_bitwise_equal": same, "ok": ok})
                    require(ok, f"fused_decoder_step {model} {dtype} B={B} "
                                f"L={L} pos={pos} disagrees with its plain "
                                f"version or with itself ({errs}, bitwise "
                                f"equal: {same})")
                    del got, again, want, exact
            del full
    torch.cuda.empty_cache()
    return main_err


def within(got, ref, atol: float, rtol: float):
    """Elementwise |got - ref| <= atol + rtol |ref|."""
    return (got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()


def fused_close(got, want, exact, atol: float, rtol: float):
    """The kernel's output within the tolerance of the plain version, or,
    where the plain version's own fp32 sums are outside it of its
    fp64-summed form (a bf16 near-tie rounded the other way and carried
    through the layers), within it of that form."""
    return within(got, want, atol, rtol) | (
        ~within(want, exact, atol, rtol) & within(got, exact, atol, rtol))


def fused_decoder_tree(packed, cfg, dtype, seed: int) -> dict:
    """A params tree whose decoder holds the packed operands (the port's
    stacked layout; biases and LayerNorm vectors in the compute dtype, as
    weights.to_device leaves them), with random embeddings."""
    import torch

    from whisper_tpu_torch.ops.decoder_step import vec_offsets
    d, ff = cfg.d_model, cfg.d_ff
    off = vec_offsets(d, ff)
    v = packed.vec.to(dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def seg(name, n=d):
        return v[:, off[name]:off[name] + n]

    def lin(w, name, n=d):
        return {"w": w, "b": seg(name, n)}

    def ln(i):
        return {"g": seg(f"ln{i}_g"), "b": seg(f"ln{i}_b")}

    layers = {"attn": {"qkv": lin(packed.wqkv, "qkv_b", 3 * d),
                       "o": lin(packed.wo, "o_b")},
              "cross_attn": {"q": lin(packed.wcq, "cq_b"),
                             "o": lin(packed.wco, "co_b")},
              "attn_ln": ln(1), "cross_ln": ln(2), "mlp_ln": ln(3),
              "fc1": lin(packed.fc1, "fc1_b", ff),
              "fc2": lin(packed.fc2, "fc2_b")}
    emb = torch.randn((cfg.vocab_size, d), generator=g, device="cuda") * 0.02
    pos = torch.randn((cfg.n_text_ctx, d), generator=g, device="cuda") * 0.02
    return {"decoder": {"tok_emb": emb.to(dtype), "pos_emb": pos.to(dtype),
                        "layers": layers,
                        "ln": {"g": torch.ones(d, device="cuda"),
                               "b": torch.zeros(d, device="cuda")}}}


def fused_bound(B: int, L: int, H: int, pos: int, e: int, dtype: str
                ) -> dict:
    """The least time of one fused_decoder_step: every weight, the packed
    fp32 vectors, the cross K/V and the pos live self rows read once, h0,
    h_out, k_new and v_new once; the products (2 B L 14 d^2) and the
    attention over pos + 1 self and 1500 cross keys."""
    d, ff = 64 * H, 256 * H
    moved = (L * 14 * d * d * e + L * (13 * d + ff) * 4
             + 2 * L * B * H * (1500 + pos) * 64 * e
             + 2 * B * d * e + 2 * L * B * H * 64 * e)
    flops = 2 * B * L * 14 * d * d + 4 * B * L * H * (pos + 1 + 1500) * 64
    return bound(moved, flops, dtype)


def fused_time(card: str) -> dict:
    """fused_time at tiny b32 and turbo b32 (4 layers), bf16 and fp32, pos
    48: the kernel and its plain version in turns (CUDA events), the
    kernel by CUDA-graph replay, and as context the whole step fused
    (embeddings, kernel, append, logits) against the port's unfused
    decoder_step_ip on a decoder of the same tensors, in turns and by
    graph replay. Returns the kernels-line numbers (tiny b32 bf16)."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.decode import _make_fused_step
    from whisper_tpu_torch.models.whisper import decoder_step_ip
    from whisper_tpu_torch.ops.decoder_step import (
        fused_decoder_step,
        fused_decoder_step_plain,
    )
    out = {}
    pos = FUSED_TIME_POS
    for model, H, iters in (("tiny", 6, 20), (TURBO, 20, 10)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            args = fused_inputs(BATCH, 4, H, dtype, seed=11)
            ms, plain_ms = alternate_ms(
                lambda: fused_decoder_step_plain(*args, pos + 1, n_heads=H),
                lambda: fused_decoder_step(*args, pos + 1, n_heads=H), iters)
            kernel_graph_ms = graph_ms(
                lambda: fused_decoder_step(*args, pos + 1, n_heads=H),
                launches=20, replays=10)
            cfg = get_config(model).replace(compute_dtype=name)
            params = fused_decoder_tree(args[1], cfg, dtype, seed=12)
            cache = {"k": args[2], "v": args[3]}
            cross = {"k": args[4], "v": args[5]}
            last = torch.randint(0, 50_000, (BATCH, 1), device="cuda")
            fused = _make_fused_step(params, cfg, cross)

            def step_fused():
                fused(last, pos, cache)

            def step_ip():
                decoder_step_ip(params, cfg, last, pos, cache, cross)

            step_ms, ip_ms = alternate_ms(step_ip, step_fused, iters)
            bnd = fused_bound(BATCH, 4, H, pos, dtype.itemsize, name)
            line = {"max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                    **bnd, "library_ms": None}
            emit({"phase": "fused_time", "model": model, "dtype": name,
                  "batch": BATCH, "layers": 4, "pos": pos, **line,
                  "graph_ms": kernel_graph_ms,
                  "bound_share": bnd["bound_ms"] / kernel_graph_ms,
                  "context_step_ms": {
                      "fused": step_ms, "decoder_step_ip": ip_ms,
                      "fused_graph": graph_ms(step_fused, 20, 10),
                      "decoder_step_ip_graph": graph_ms(step_ip, 20, 10)},
                  "card": card})
            if model == "tiny" and dtype == torch.bfloat16:
                out = line
            del args, params, cache, cross, fused
            torch.cuda.empty_cache()
    return out


def phase_breakdown(timelines: list) -> dict:
    """Per-step microseconds by phase kind from the kernel's timelines
    ((kind, ns) pairs, ended by kind -1): each interval between two stamps
    is charged to the phase whose barrier closed it (its work and its wait
    at that barrier); "sync" intervals are back-to-back barriers, their
    median the cost of one barrier."""
    from whisper_tpu_torch.ops.decoder_step import PHASES
    phases, probes, barriers = {}, [], 0
    for tl in timelines:
        pairs = tl.reshape(-1, 2)
        end = int(np.argmax(pairs[:, 0] < 0))
        for (_, t0), (kind, t1) in zip(pairs[:end - 1], pairs[1:end]):
            name = PHASES[int(kind)]
            if name == "sync":
                probes.append(int(t1 - t0))
                continue
            phases[name] = phases.get(name, 0) + int(t1 - t0)
            barriers += name != "final"
    n = len(timelines)
    us = {k: v / n / 1e3 for k, v in phases.items()}
    step_us = sum(us.values())
    barrier_us = float(np.median(probes)) / 1e3
    per_step = barriers / n
    return {"phase_us": us, "step_us": step_us, "barriers": per_step,
            "barrier_us": barrier_us,
            "barrier_share": per_step * barrier_us / step_us}


def fused_phases(card: str) -> None:
    """fused_phases: where one fused decoder step spends its time, at tiny
    and turbo b32 bf16 (4 layers), pos 48. Block 0's timeline (the
    kernel's `stamps` buffer) over FUSED_PHASE_STEPS steps, summed by phase
    kind per step, the cost of one barrier from back-to-back probes, the
    barriers' share of the step; beside it the step's CUDA-event time with
    and without the timeline (what the stamps cost)."""
    import torch

    from whisper_tpu_torch.ops.decoder_step import (
        fused_decoder_step,
        stamp_pairs,
    )
    pos = FUSED_TIME_POS
    for model, H in (("tiny", 6), (TURBO, 20)):
        args = fused_inputs(BATCH, 4, H, torch.bfloat16, seed=11)
        stamps = torch.empty(2 * stamp_pairs(4), dtype=torch.int64,
                             device="cuda")
        timelines = []
        for _ in range(3 + FUSED_PHASE_STEPS):
            fused_decoder_step(*args, pos + 1, n_heads=H, stamps=stamps)
            timelines.append(stamps.cpu().numpy())
        plain_ms = cuda_ms(lambda: fused_decoder_step(*args, pos + 1,
                                                      n_heads=H), 20)
        stamped_ms = cuda_ms(lambda: fused_decoder_step(
            *args, pos + 1, n_heads=H, stamps=stamps), 20)
        emit({"phase": "fused_phases", "model": model, "dtype": "bfloat16",
              "batch": BATCH, "layers": 4, "pos": pos,
              **phase_breakdown(timelines[3:]), "ms": plain_ms,
              "ms_with_timeline": stamped_ms, "card": card})
        del args, stamps
        torch.cuda.empty_cache()


def fused_step_logit_err(params, cfg, clips) -> float:
    """One fused fp32 step's logits on the card against the CPU's, each
    after its own prefill of the same clips: the largest abs difference."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import (
        _greedy_prefill,
        _make_fused_step,
        encode,
    )
    from whisper_tpu_torch.pipeline import WhisperPipeline
    logits = {}
    for device in ("cuda", "cpu"):
        p = WhisperPipeline.from_params(params, cfg, dtype="float32",
                                        device=device, quant="off")
        wav = torch.from_numpy(clips).to(device)
        enc = encode(p.params, p.cfg, log_mel_spectrogram(wav, p.cfg))
        prompt = p.prompt(len(clips))
        P = prompt.shape[1]
        with torch.inference_mode():
            cross, cache, _, pre = _greedy_prefill(p.params, p.cfg, enc,
                                                   prompt, P + 2)
            step = _make_fused_step(p.params, p.cfg, cross)
            lg, _ = step(pre[:, -1].argmax(-1)[:, None], P, cache)
        logits[device] = lg.float().cpu()
        del p, wav, enc, cross, cache, pre
    torch.cuda.empty_cache()
    return float((logits["cuda"] - logits["cpu"]).abs().max())


def ragged_positions(B: int, S: int, seed: int, outside=None) -> np.ndarray:
    """A (B,) position vector from a seed with 0, S-1 and a repeated value;
    with `outside`, the last row's position lies outside [0, S)."""
    pos = np.random.RandomState(seed).randint(0, S, size=B)
    pos[0], pos[1] = 0, S - 1
    pos[3] = pos[4] = pos[2]
    if outside is not None:
        pos[-1] = outside
    return pos


def ragged_checks(card: str) -> dict:
    """ragged_vs_plain: the ragged append against its plain version, exact
    and in place, at tiny's and turbo's engine shapes in fp32 and bf16,
    with one row outside [0, S) that must stay untouched; then ragged_time
    at tiny's engine shape in bf16. Returns the kernels-line numbers."""
    import torch

    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows_ragged,
        cache_append_rows_ragged_plain,
    )
    g = torch.Generator(device="cpu").manual_seed(6)
    err = 0.0
    for name, shape in RAGGED_SHAPES.items():
        L, B, H, S, D = shape
        for dtype, outside in ((torch.float32, S), (torch.bfloat16, -1)):
            ck, cv = (torch.randn(shape, generator=g).to("cuda", dtype)
                      for _ in range(2))
            kn, vn = (torch.randn((L, B, H, D), generator=g).to("cuda", dtype)
                      for _ in range(2))
            pos = torch.from_numpy(ragged_positions(B, S, B, outside)).cuda()
            before = (ck[:, -1].clone(), cv[:, -1].clone())
            want_k, want_v = cache_append_rows_ragged_plain(
                ck.clone(), cv.clone(), kn, vn, pos)
            ptrs = (ck.data_ptr(), cv.data_ptr())
            got_k, got_v = cache_append_rows_ragged(ck, cv, kn, vn, pos)
            torch.cuda.synchronize()
            in_place = (got_k.data_ptr(), got_v.data_ptr()) == ptrs
            exact = bool(torch.equal(got_k, want_k)
                         and torch.equal(got_v, want_v))
            untouched = bool(torch.equal(got_k[:, -1], before[0])
                             and torch.equal(got_v[:, -1], before[1]))
            err = max(err, float((got_k.float() - want_k.float()).abs().max()),
                      float((got_v.float() - want_v.float()).abs().max()))
            emit({"phase": "ragged_vs_plain", "engine": name,
                  "dtype": str(dtype),
                  "shape": list(shape), "pos": pos.tolist(), "exact": exact,
                  "in_place": in_place, "outside_row_untouched": untouched})
            require(exact and in_place and untouched,
                    f"cache_append_rows_ragged {name} {dtype}: exact={exact} "
                    f"in_place={in_place} untouched={untouched}")
            del ck, cv, kn, vn, want_k, want_v, before

    # ragged_time at tiny's engine shape, bf16, every position in range
    # (the library call's indices must be)
    L, B, H, S, D = shape = RAGGED_SHAPES["tiny"]
    ck, cv = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
              for _ in range(2))
    kn, vn = (torch.randn((L, B, H, D), generator=g).to("cuda", torch.bfloat16)
              for _ in range(2))
    pos = torch.from_numpy(ragged_positions(B, S, 7)).cuda()
    rows = torch.arange(B, device="cuda")

    def kernel():
        cache_append_rows_ragged(ck, cv, kn, vn, pos)

    def plain():
        cache_append_rows_ragged_plain(ck, cv, kn, vn, pos)

    def library():      # the JAX fallback's indexed assignment, per cache
        ck[:, rows, :, pos, :] = kn.transpose(0, 1)
        cv[:, rows, :, pos, :] = vn.transpose(0, 1)

    ms, plain_ms = alternate_ms(plain, kernel, iters=200)
    library_ms = cuda_ms(library, iters=200)
    graphs = {name: graph_ms(fn) for name, fn in
              (("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
    # every row in range: k_new, v_new and pos read once, 2 x L*B*H*D
    # values written
    moved = 2 * 2 * kn.numel() * kn.element_size() + pos.numel() * 8
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bound(moved, 0, "bfloat16")}
    emit({"phase": "ragged_time", "shape": list(shape), "dtype": "bfloat16",
          **out, "graph": graphs, "card": card})
    return out


def q8_inputs(B: int, H: int, S: int, dtype, g):
    """q (B, 1, H, 64) in dtype and int8 K/V with per-vector scales,
    quantized on the card by the port's quantize_kv."""
    import torch

    from whisper_tpu_torch.models.whisper import quantize_kv
    q = torch.randn((B, 1, H, 64), generator=g).to("cuda", dtype)
    k8, ks = quantize_kv(torch.randn((B, H, S, 64), generator=g).cuda() * 2)
    v8, vs = quantize_kv(torch.randn((B, H, S, 64), generator=g).cuda())
    return q, k8, ks, v8, vs


def q8_checks(card: str) -> dict:
    """q8_vs_plain: both wrappers of the int8 decode kernel against the
    plain version at tiny's and turbo's b32 cross shapes (all 1500 keys)
    and at tiny's with kv_len 0, 1, 77 and 1499, fp32 and bf16; then
    q8_time for each wrapper at both b32 shapes in fp32 (the main path's
    dtype for this kernel). Returns the kernels-line numbers by wrapper
    (tiny b32 fp32; max_abs_err over the fp32 cases)."""
    import torch

    from whisper_tpu_torch.ops.decode_attention import (
        decode_attention_q8,
        decode_attention_q8_bh,
        decode_attention_q8_plain,
    )
    wrappers = {"decode_attention_q8_bh": decode_attention_q8_bh,
                "decode_attention_q8": decode_attention_q8}
    shapes = {"tiny": (BATCH, 6), "turbo": (BATCH, 20)}
    cases = [("tiny", None), ("turbo", None), ("tiny", 0), ("tiny", 1),
             ("tiny", 77), ("tiny", 1499)]
    g = torch.Generator(device="cpu").manual_seed(8)
    err = {name: 0.0 for name in wrappers}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = Q8_TOL[str(dtype).split(".")[1]]
        for model, kv_len in cases:
            B, H = shapes[model]
            args = q8_inputs(B, H, 1500, dtype, g)
            want = decode_attention_q8_plain(*args, kv_len).float()
            for name, fn in wrappers.items():
                got = fn(*args, kv_len).float()
                torch.cuda.synchronize()
                e = (got - want).abs()
                ok = bool((e <= atol + rtol * want.abs()).all())
                if kv_len == 0:
                    ok = ok and not bool(got.any())
                if dtype == torch.float32:      # the main path's dtype
                    err[name] = max(err[name], float(e.max()))
                emit({"phase": "q8_vs_plain", "wrapper": name,
                      "dtype": str(dtype), "shape": [B, 1, H, 64],
                      "S": 1500, "kv_len": kv_len,
                      "max_abs_err": float(e.max()), "atol": atol,
                      "rtol": rtol, "ok": ok})
                require(ok, f"{name} {dtype} {model} kv_len={kv_len} "
                            f"disagrees with its plain version "
                            f"(max abs err {float(e.max())})")
            del args, want
    out = {}
    for model, (B, H) in shapes.items():
        args = q8_inputs(B, H, 1500, torch.float32, g)
        # int8 K and V and their fp32 scales read once, q read and the
        # output written once; 4 FLOP per key and dim on the fp32 cores
        moved = 2 * B * H * 1500 * (64 + 4) + 2 * args[0].numel() * 4
        bnd = bound(moved, 4 * B * H * 1500 * 64, "float32")
        for name, fn in wrappers.items():
            ms, plain_ms = alternate_ms(
                lambda: decode_attention_q8_plain(*args),
                lambda: fn(*args), iters=50)
            line = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                    **bnd, "library_ms": None}
            emit({"phase": "q8_time", "wrapper": name, "model": model,
                  "shape": [B, 1, H, 64], "S": 1500, "dtype": "float32",
                  **decode_plan(B, H, 1500, 1), **line,
                  "graph_ms": graph_ms(lambda: fn(*args)),
                  "bound_share": bnd["bound_ms"] / ms, "card": card})
            if model == "tiny":
                out[name] = line
        del args
    torch.cuda.empty_cache()
    return out


def decode_wrappers() -> dict:
    """The fp32/bf16 decode wrappers by name, each with its plain version
    and its keyword arguments (bg at the JAX default block_b 8)."""
    from whisper_tpu_torch.ops import decode_attention as da
    return {"decode_attention_bh": (da.decode_attention_bh,
                                    da.decode_attention_bh_plain, {}),
            "decode_attention_bg": (da.decode_attention_bg,
                                    da.decode_attention_bg_plain,
                                    {"block_b": 8}),
            "decode_attention": (da.decode_attention,
                                 da.decode_attention_plain, {})}


def decode_checks(card: str) -> dict:
    """decode_vs_plain: the three wrappers of the fp32/bf16 decode kernel
    against their plain versions at DECODE_CASES (bg at block_b 8, or the
    whole batch where it is smaller), fp32 and bf16, with NaN
    written into every K/V row at or past kv_len (the kernel must not read
    it; the plain version reads only the rows before it); bg's refusal of
    a batch that block_b 8 does not divide. Returns the largest bf16 error
    by wrapper (the main paths' dtype)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(10)
    err = {name: 0.0 for name in decode_wrappers()}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = DECODE_TOL[str(dtype).split(".")[1]]
        for case, (B, H, S, kv_lens) in DECODE_CASES.items():
            q = torch.randn((B, 1, H, 64), generator=g).to("cuda", dtype)
            k, v = (torch.randn((B, H, S, 64), generator=g).to("cuda", dtype)
                    for _ in range(2))
            for kv_len in kv_lens:
                live = S if kv_len is None else kv_len
                kp, vp = k.clone(), v.clone()
                kp[:, :, live:] = float("nan")
                vp[:, :, live:] = float("nan")
                for name, (fn, plain, kw) in decode_wrappers().items():
                    if kw.get("block_b", 1) > B:    # the long cache's B=4
                        kw = {"block_b": B}
                    want = plain(q, kp, vp, kv_len, **kw).float()
                    got = fn(q, kp, vp, kv_len, **kw).float()
                    torch.cuda.synchronize()
                    e = (got - want).abs()
                    ok = bool(torch.isfinite(got).all()
                              and (e <= atol + rtol * want.abs()).all())
                    if kv_len == 0:
                        ok = ok and not bool(got.any())
                    if dtype == torch.bfloat16:
                        err[name] = max(err[name], float(e.max()))
                    emit({"phase": "decode_vs_plain", "wrapper": name,
                          "case": case, "dtype": str(dtype), **kw,
                          "shape": [B, 1, H, 64], "S": S, "kv_len": kv_len,
                          "nan_past_kv_len": live < S,
                          "max_abs_err": float(e.max()), "atol": atol,
                          "rtol": rtol, "ok": ok})
                    require(ok, f"{name} {dtype} {case} kv_len={kv_len} "
                                f"disagrees with its plain version (max abs "
                                f"err {float(e.max())})")
                del kp, vp
            del q, k, v
    fn = decode_wrappers()["decode_attention_bg"][0]
    q = torch.zeros((12, 1, 6, 64), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((12, 6, 16, 64), device="cuda", dtype=torch.bfloat16)
    try:
        fn(q, k, k, block_b=8)
        refused = False
    except ValueError:
        refused = True
    emit({"phase": "decode_vs_plain", "wrapper": "decode_attention_bg",
          "case": "batch_12_block_b_8", "refuses": refused})
    require(refused, "decode_attention_bg took a batch of 12 at block_b 8")
    torch.cuda.empty_cache()
    return err


def decode_plan(B: int, H: int, kv_len: int, kv_bytes: int) -> dict:
    """The decode wrappers' plan for this read here: split count and
    warps a block."""
    import torch

    from whisper_tpu_torch.ops import decode_attention as da
    n, _, warps = da._split_plan(B * H, kv_len, da._sm_count(
        torch.device("cuda", torch.cuda.current_device())), kv_bytes)
    return {"n_split": n, "warps": warps}


def decode_time(card: str) -> dict:
    """decode_time: each wrapper at DECODE_TIME's shapes in bf16, the
    kernel and its plain version in turns (CUDA events), the kernel by
    CUDA-graph replay, and the one PyTorch call for the same function
    (scaled_dot_product_attention over k[:, :, :kv_len], timed here and
    never called by the port) by events and by replay, beside the bound
    and the split count the plan took. Returns the kernels-line numbers by
    wrapper (tiny b32 bf16 cross read)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(11)
    out = {}
    for case, (B, H, S, kv_len) in DECODE_TIME.items():
        q = torch.randn((B, 1, H, 64), generator=g).to("cuda", torch.bfloat16)
        k, v = (torch.randn((B, H, S, 64), generator=g).to(
            "cuda", torch.bfloat16) for _ in range(2))
        qt, ks, vs = q.transpose(1, 2), k[:, :, :kv_len], v[:, :, :kv_len]

        def sdpa():
            return F.scaled_dot_product_attention(qt, ks, vs)

        library_ms = cuda_ms(sdpa, iters=50)
        library_graph_ms = graph_ms(sdpa)
        # K/V's live rows read once, q read and the output written once;
        # 4 FLOP per live key and dim
        bnd = bound(2 * B * H * kv_len * 64 * 2 + 2 * q.numel() * 2,
                    4 * B * H * kv_len * 64, "bfloat16")
        for name, (fn, plain, kw) in decode_wrappers().items():
            ms, plain_ms = alternate_ms(lambda: plain(q, k, v, kv_len, **kw),
                                        lambda: fn(q, k, v, kv_len, **kw),
                                        iters=50)
            replay_ms = graph_ms(lambda: fn(q, k, v, kv_len, **kw))
            line = {"ms": ms, "plain_ms": plain_ms, **bnd,
                    "library_ms": library_ms}
            emit({"phase": "decode_time", "wrapper": name, "case": case,
                  "shape": [B, 1, H, 64], "S": S, "kv_len": kv_len,
                  "dtype": "bfloat16", **decode_plan(B, H, kv_len, 2),
                  **line, "graph_ms": replay_ms,
                  "library_graph_ms": library_graph_ms,
                  "bound_share": bnd["bound_ms"] / replay_ms, "card": card})
            if case == "tiny_cross":
                out[name] = line
        del q, k, v, qt, ks, vs
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def forced_plan(n_split: int, warps: int):
    """The decode wrappers' plan replaced by n_split splits of
    ceil(kv_len / n_split) keys with `warps` warps a block."""
    from whisper_tpu_torch.ops import decode_attention as da
    plan = da._split_plan
    da._split_plan = (lambda bh, kv_len, sms, kv_bytes=2:
                      (n_split, -(-kv_len // n_split), warps))
    da._launch_plan.cache_clear()
    try:
        yield
    finally:
        da._split_plan = plan
        da._launch_plan.cache_clear()


def decode_split_ab(card: str) -> None:
    """decode_split_ab: decode_attention_bh in bf16 at SPLIT_AB's reads:
    its output against the plain version (NaN past kv_len), then by
    replay, in turns, the read as the plan launches it, the same read in
    one split with 8 and with WIDE_WARPS warps a block, and SDPA over
    k[:, :, :kv_len] (timed here, never called by the port)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.ops import decode_attention as da
    g = torch.Generator(device="cpu").manual_seed(13)
    atol, rtol = DECODE_TOL["bfloat16"]
    for case, (B, H, S, kv_len) in SPLIT_AB.items():
        q = torch.randn((B, 1, H, 64), generator=g).to("cuda", torch.bfloat16)
        k, v = (torch.randn((B, H, S, 64), generator=g).to(
            "cuda", torch.bfloat16) for _ in range(2))
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
        plan = decode_plan(B, H, kv_len, 2)
        want = da.decode_attention_bh_plain(q, k, v, kv_len).float()
        got = da.decode_attention_bh(q, k, v, kv_len).float()
        e = (got - want).abs()
        ok = bool(torch.isfinite(got).all()
                  and (e <= atol + rtol * want.abs()).all())
        qt, ks, vs = q.transpose(1, 2), k[:, :, :kv_len], v[:, :, :kv_len]

        def read():
            return da.decode_attention_bh(q, k, v, kv_len)

        def one_split(warps):
            with forced_plan(1, warps):
                return graph_ms(read)

        def sdpa():
            return F.scaled_dot_product_attention(qt, ks, vs)

        first = [graph_ms(read), one_split(8), one_split(da.WIDE_WARPS),
                 graph_ms(sdpa)]
        last = [graph_ms(sdpa), one_split(da.WIDE_WARPS), one_split(8),
                graph_ms(read)][::-1]
        (split_ms, one8_ms, one_wide_ms, library_ms) = (
            (x + y) / 2 for x, y in zip(first, last))
        emit({"phase": "decode_split_ab", "case": case,
              "shape": [B, 1, H, 64], "S": S, "kv_len": kv_len, **plan,
              "max_abs_err": float(e.max()), "atol": atol, "rtol": rtol,
              "ok": ok, "graph_ms": split_ms,
              "one_split_graph_ms": {8: one8_ms, da.WIDE_WARPS: one_wide_ms},
              "library_graph_ms": library_ms,
              "one_split_over_split": min(one8_ms, one_wide_ms) / split_ms,
              "readings": {"split": [first[0], last[0]],
                           "library": [first[3], last[3]]},
              **bound(2 * B * H * kv_len * 64 * 2 + 2 * q.numel() * 2,
                      4 * B * H * kv_len * 64, "bfloat16"), "card": card})
        require(ok, f"decode_split_ab {case}: the split read disagrees with "
                    f"its plain version (max abs err {float(e.max())})")
        del q, k, v, qt, ks, vs, want, got
    torch.cuda.empty_cache()


def decode_wall(card: str) -> None:
    """decode_wall: the wall time per call of decode_attention_bh at tiny
    b32's bf16 self read (93 of 448 keys, ~3.5 us on the card) and of
    decode_attention_q8_bh at tiny b32's fp32 int8 cross read, 500 calls
    back to back between two synchronizations, the median and least of
    seven such runs. Where the card's time is below the host's, this is
    the wrapper's own cost on the host."""
    import torch

    from whisper_tpu_torch.ops import decode_attention as da
    g = torch.Generator(device="cpu").manual_seed(14)
    q = torch.randn((BATCH, 1, 6, 64), generator=g).to("cuda", torch.bfloat16)
    k, v = (torch.randn((BATCH, 6, 448, 64), generator=g).to(
        "cuda", torch.bfloat16) for _ in range(2))
    q8 = q8_inputs(BATCH, 6, 1500, torch.float32, g)
    calls = {"decode_attention_bh": lambda: da.decode_attention_bh(
                 q, k, v, 93),
             "decode_attention_q8_bh": lambda: da.decode_attention_q8_bh(
                 *q8)}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        runs = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / 500 * 1e6)
        emit({"phase": "decode_wall", "wrapper": name,
              "us_median": sorted(runs)[3], "us_min": min(runs),
              "runs_us": runs, "card": card})
    del q, k, v, q8
    torch.cuda.empty_cache()


def decode_split_sweep(card: str) -> None:
    """decode_split_sweep: decode_attention_bh in bf16 at the b32 cross
    reads and the long cache (B=4, 8000 of 8192 keys) by replay with 8 and
    WIDE_WARPS warps a block and the split count forced to each of
    SPLIT_SWEEP in turn (the plan's own choice marked), to check the plan
    against the choices it did not make."""
    import torch

    from whisper_tpu_torch.ops import decode_attention as da
    g = torch.Generator(device="cpu").manual_seed(12)
    for case in ("tiny_cross", "turbo_cross", "long_cache"):
        B, H, S, kv_len = DECODE_TIME.get(case) or (
            DECODE_CASES[case][:3] + DECODE_CASES[case][3])
        q = torch.randn((B, 1, H, 64), generator=g).to("cuda", torch.bfloat16)
        k, v = (torch.randn((B, H, S, 64), generator=g).to(
            "cuda", torch.bfloat16) for _ in range(2))
        times = {}
        for warps in (8, da.WIDE_WARPS):
            times[warps] = {}
            for n in SPLIT_SWEEP:
                with forced_plan(n, warps):
                    times[warps][n] = graph_ms(
                        lambda: da.decode_attention_bh(q, k, v, kv_len))
        emit({"phase": "decode_split_sweep", "case": case,
              "shape": [B, 1, H, 64], "S": S, "kv_len": kv_len,
              "graph_ms_by_warps_and_n_split": times,
              "plan": decode_plan(B, H, kv_len, 2), "card": card})
        del q, k, v
    torch.cuda.empty_cache()


def append_int8_checks(card: str) -> None:
    """append_int8_vs_plain: the scalar append on int8 caches at the two
    shapes the main path gives it, tiny b32 and turbo b32 (L, B, H, 128,
    64), exact and in place at four positions each; then its time at
    turbo's shape, the one the int8 self cache of serving_turbo runs."""
    import torch

    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
    )
    g = torch.Generator(device="cpu").manual_seed(9)

    def ints(s):
        return torch.randint(-127, 128, s, generator=g,
                             dtype=torch.int8).cuda()

    for model, H in (("tiny", 6), ("turbo", 20)):
        shape = (4, BATCH, H, 128, 64)
        for pos in (0, 5, 63, 127):
            ck, cv = ints(shape), ints(shape)
            kn, vn = ints(shape[:3] + (64,)), ints(shape[:3] + (64,))
            want_k, want_v = cache_append_rows_plain(ck.clone(), cv.clone(),
                                                     kn, vn, pos)
            ptrs = (ck.data_ptr(), cv.data_ptr())
            got_k, got_v = cache_append_rows(ck, cv, kn, vn, pos)
            torch.cuda.synchronize()
            in_place = (got_k.data_ptr(), got_v.data_ptr()) == ptrs
            exact = bool(torch.equal(got_k, want_k)
                         and torch.equal(got_v, want_v))
            emit({"phase": "append_int8_vs_plain", "model": model,
                  "pos": pos, "shape": list(shape), "exact": exact,
                  "in_place": in_place})
            require(exact and in_place,
                    f"cache_append_rows int8 {model} pos {pos}: "
                    f"exact={exact} in_place={in_place}")
    ms, plain_ms = alternate_ms(
        lambda: cache_append_rows_plain(ck, cv, kn, vn, 63),
        lambda: cache_append_rows(ck, cv, kn, vn, 63), iters=200)
    emit({"phase": "append_time", "model": "turbo", "shape": list(shape),
          "dtype": "int8", "ms": ms, "plain_ms": plain_ms,
          **bound(2 * 2 * kn.numel(), 0, "bfloat16"), "card": card})


def serving_logits_vs_cpu(params, model, clips, card: str,
                          vocab_path=None) -> None:
    """The serving path's prefill logits (quant="auto", bf16) on the card
    against the port on the CPU, same params and clips."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_prefill, encode
    from whisper_tpu_torch.pipeline import WhisperPipeline
    logits = {}
    for device in ("cuda", "cpu"):
        pipe = WhisperPipeline.from_params(params, model, dtype="bfloat16",
                                           device=device, quant="auto",
                                           batch_hint=BATCH,
                                           vocab_path=vocab_path)
        wav = torch.from_numpy(clips).to(device)
        enc = encode(pipe.params, pipe.cfg, log_mel_spectrogram(wav, pipe.cfg))
        with torch.inference_mode():
            pre = _greedy_prefill(pipe.params, pipe.cfg, enc,
                                  pipe.prompt(len(clips)), 4 + 1 + 12)
        logits[device] = pre[3].float().cpu()
        del pipe, wav, enc, pre
    torch.cuda.empty_cache()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    agree = float((logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)
                   ).float().mean())
    emit({"phase": "serving_logits_vs_cpu", "model": model,
          "batch": len(clips), "max_abs_err": err,
          "atol": SERVING_LOGITS_ATOL, "argmax_agreement": agree,
          "card": card})
    require(err <= SERVING_LOGITS_ATOL,
            f"{model} serving prefill logits differ by {err} on the card")


def int8_logits_vs_cpu(params, cfg, clips, card: str) -> None:
    """First-step logits of an int8 encoder configuration (cfg, bf16,
    quant "off") on the card against the port on the CPU: the prefill's
    last-position logits over `clips`, within INT8_LOGITS_REL of the
    largest |logit|."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import _greedy_prefill, encode
    from whisper_tpu_torch.pipeline import WhisperPipeline
    logits = {}
    for device in ("cuda", "cpu"):
        pipe = WhisperPipeline.from_params(params, cfg, dtype="bfloat16",
                                           device=device, quant="off")
        wav = torch.from_numpy(clips).to(device)
        enc = encode(pipe.params, pipe.cfg, log_mel_spectrogram(wav, pipe.cfg))
        with torch.inference_mode():
            pre = _greedy_prefill(pipe.params, pipe.cfg, enc,
                                  pipe.prompt(len(clips)), 4 + 1 + 12)
        logits[device] = pre[3].float().cpu()
        del pipe, wav, enc, pre
    torch.cuda.empty_cache()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    rel = err / float(logits["cpu"].abs().max())
    agree = float((logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)
                   ).float().mean())
    emit({"phase": "int8_logits_vs_cpu", "model": cfg.name,
          "quant": quant_flags(cfg) + (["encoder_quant"]
                                       if cfg.encoder_quant else []),
          "batch": len(clips), "max_abs_err": err, "rel_err": rel,
          "rel_tol": INT8_LOGITS_REL, "argmax_agreement": agree,
          "card": card})
    require(rel <= INT8_LOGITS_REL,
            f"{cfg.name} int8 encoder logits differ by {rel:.4f} of the "
            f"largest on the card")


def encoder_int8_path(pipe, params, kernels: dict, card: str) -> int:
    """The tiny b32 bf16 workload (89 greedy tokens, EOT banned) through
    transcribe_batch with the encoder's int8 paths: encoder_mlp_quant with
    encoder_qkv_quant (the tail's int8 form, with the int8 o-projection:
    one encoder_block_tail_q8 launch a layer, no unquantized tail), then
    encoder_quant (int8 projections, the tail bypassed: the attention
    through flash, no tail launch). Each against `pipe` (the unquantized
    path) in turns, and its first-step logits against the CPU. Returns the
    int8 tail's launches."""
    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    cfg = get_config("tiny")
    L = cfg.n_audio_layers
    rest = {"cache_append_rows": GEN_TOKENS - 1,
            "cache_append_rows_ragged": 0, "decode_attention_q8_bh": 0,
            "decode_attention_q8": 0, "fused_decoder_step": 0, **NO_DECODE}
    launches = 0
    clips = bench_audio(cfg, 2)
    for label, flags, expect in (
            ("encoder_int8_mlp", {"encoder_mlp_quant": True,
                                  "encoder_qkv_quant": True},
             {"encoder_block_tail_q8": L, "encoder_block_tail": 0,
              "flash_attention": 0}),
            ("encoder_int8_all", {"encoder_quant": True},
             {"encoder_block_tail_q8": 0, "encoder_block_tail": 0,
              "flash_attention": L})):
        qcfg = cfg.replace(**flags)
        qpipe = WhisperPipeline.from_params(params, qcfg, dtype="bfloat16",
                                            device="cuda", quant="off")
        _, audio, bias, line = main_path(qpipe, kernels, {**expect, **rest},
                                         card, label=label)
        if label == "encoder_int8_mlp":
            launches = line["launches"]["encoder_block_tail_q8"]
        on_off_ab(label + "_ab", {"off": pipe, "on": qpipe}, audio, bias,
                  card)
        del qpipe
        int8_logits_vs_cpu(params, qcfg, clips, card)
    return launches


def card_init_params(cfg, seed: int):
    """init_params' tree and scales (normal x 0.02 weights, zero biases,
    LayerNorm ones and zeros, the sinusoidal encoder positions), drawn on
    the card from a seeded generator: a full-size model in a fraction of
    the time of init_params' host draws."""
    import torch

    from whisper_tpu_torch.models.whisper import sinusoidal_positions
    from whisper_tpu_torch.weights import param_shapes
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(tree, key=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        if key in ("g", "b"):
            return torch.full(tree, 1.0 if key == "g" else 0.0,
                              device="cuda")
        return torch.randn(tree, generator=g, device="cuda") * 0.02

    shapes = param_shapes(cfg)
    enc = {k: draw(v, k) for k, v in shapes["encoder"].items()
           if k != "pos_emb"}
    enc["pos_emb"] = sinusoidal_positions(*shapes["encoder"]["pos_emb"]
                                          ).cuda()
    return {"encoder": enc, "decoder": draw(shapes["decoder"])}


def solo_identity(make_engine, request, want: list, label: str,
                  card: str) -> None:
    """One request alone in a fresh engine (the same slot count: bf16
    GEMMs differ between batch sizes) against its tokens in a crowded
    run."""
    audio, kw = request
    eng = make_engine()
    rid = eng.submit(audio, **kw)
    got = eng.run_until_idle()[rid]
    emit({"phase": "continuous_quant_solo", "case": label,
          "identical": got == want, "tokens": len(got), "card": card})
    require(got == want, f"{label}: a request's tokens alone differ from "
                         f"its tokens in the crowded run")
    del eng


def continuous_quant(params, kernels: dict, unquantized_tokens_per_s: float,
                     card: str, profile: bool = False
                     ) -> tuple[int, int, int]:
    """The continuous engine on int8 caches. (a) Tiny, 32 slots, 96
    requests (the existing traffic) under quant="auto" as the JAX server
    builds it (the pipeline's config and params, no batch hint): weight-only
    int8 and the int8 cross cache, read scale-commuted; tokens/s beside the
    unquantized engine's in this process. (b) Medium at full width and
    depth under quant="auto": weight-only int8, the int8 cross cache, the
    int8 self cache (one int8 ragged append launch a step) and the two
    encoder tail flags: the tail's int8 form, one launch a layer a fill
    (24), with the int8 QKV in front. (c) Tiny fp32
    with the int8 cross cache under "pallas_interpret", the backend under
    which JAX's ragged step sends its T==1 int8 cross read to
    decode_attention_q8_bh: one launch per layer per step; two requests'
    tokens against the CPU engine's. In each, one request alone equals its
    tokens in the crowd. With `profile`, (a) and (b) are driven once more
    under torch.profiler (profile_engine). Returns the medium engine's
    ragged launches, the fp32 engine's decode_attention_q8_bh launches and
    the medium engine's int8 tail launches."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher

    # (a) tiny under the serving default
    cfg = get_config("tiny")
    spipe = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                        device="cuda", quant="auto")
    require(quant_flags(spipe.cfg) == ["weight_quant", "cross_kv_quant"],
            f"tiny engine auto quant: {quant_flags(spipe.cfg)}")

    def tiny_engine():
        return ContinuousBatcher(spipe.params, spipe.cfg, max_slots=BATCH,
                                 max_new=ENGINE_MAX_NEW,
                                 tokenizer=spipe.tokenizer)

    reqs = engine_traffic(cfg, ENGINE_REQUESTS, seed=0)
    engine = tiny_engine()
    line, rerun, results = continuous_run(engine, reqs, kernels,
                                          "continuous_quant_tiny", card)
    line["quant"] = quant_flags(spipe.cfg)
    line["unquantized_tokens_per_s"] = unquantized_tokens_per_s
    line["cross_dtype"] = str(engine.state["cross"]["k"].dtype)
    check_engine_launches(line, engine, spipe.cfg, 0)
    if profile:
        profile_engine(rerun, line["wall_s"], "tiny_auto", card)
    del engine, rerun
    solo_identity(tiny_engine, reqs[5], results[5], "tiny_auto", card)
    del spipe
    gc.collect()
    torch.cuda.empty_cache()

    # (b) medium at full width and depth under the serving default
    mcfg = get_config("medium")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mparams = card_init_params(mcfg, seed=0)
    mpipe = WhisperPipeline.from_params(mparams, "medium", dtype="bfloat16",
                                        device="cuda", quant="auto")
    del mparams
    init_s = time.perf_counter() - t0
    require(quant_flags(mpipe.cfg) == [
        "weight_quant", "cross_kv_quant", "self_kv_quant",
        "encoder_mlp_quant", "encoder_qkv_quant"],
        f"medium engine auto quant: {quant_flags(mpipe.cfg)}")

    def medium_engine():
        return ContinuousBatcher(mpipe.params, mpipe.cfg, max_slots=8,
                                 max_new=MEDIUM_ENGINE_MAX_NEW,
                                 tokenizer=mpipe.tokenizer)

    reqs = engine_traffic(mcfg, MEDIUM_ENGINE_REQUESTS, seed=1)
    engine = medium_engine()
    require(engine.state["cache"]["k"].dtype == torch.int8,
            "the medium engine's self cache is not int8")
    line, rerun, results = continuous_run(engine, reqs, kernels,
                                          "continuous_quant_medium", card)
    line["quant"] = quant_flags(mpipe.cfg)
    line["init_s"] = init_s
    line["self_cache_dtype"] = str(engine.state["cache"]["k"].dtype)
    line["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    medium = check_engine_launches(line, engine, mpipe.cfg, 0)
    require(medium["encoder_block_tail_q8"]
            == mcfg.n_audio_layers * line["fills"] > 0,
            "continuous_quant_medium: not one int8 tail launch per encoder "
            "layer a fill")
    if profile:
        profile_engine(rerun, line["wall_s"], "medium_auto", card)
    del engine, rerun
    solo_identity(medium_engine, reqs[5], results[5], "medium_auto", card)
    del mpipe
    gc.collect()
    torch.cuda.empty_cache()

    # (c) tiny fp32, int8 cross cache, every cross read one q8 launch
    qcfg = cfg.replace(cross_kv_quant=True, attn_backend="pallas_interpret")

    def q8_engine(device="cuda"):
        return ContinuousBatcher(params, qcfg, max_slots=8,
                                 max_new=Q8_ENGINE_MAX_NEW, device=device)

    reqs = engine_traffic(cfg, Q8_ENGINE_REQUESTS, seed=2)
    engine = q8_engine()
    line, _, results = continuous_run(engine, reqs, kernels,
                                      "continuous_q8_fp32", card)
    q8_launches = check_engine_launches(line, engine, qcfg, 0)[
        "decode_attention_q8_bh"]
    require(line["launches"]["decode_attention_q8_bh"]
            >= cfg.n_text_layers * line["engine_steps"],
            "continuous_q8_fp32: a cross read missed the q8 kernel")
    del engine
    solo_identity(q8_engine, reqs[5], results[5], "q8_fp32", card)
    cpu = q8_engine("cpu")
    picks = (0, 3)                       # the 8 and the 32 prompt buckets
    rids = [cpu.submit(reqs[i][0], **reqs[i][1]) for i in picks]
    out = cpu.run_until_idle()
    same = [out[r] == results[i] for r, i in zip(rids, picks)]
    emit({"phase": "continuous_q8_fp32_vs_cpu", "requests": list(picks),
          "identical": same, "card": card})
    require(all(same), "continuous_q8_fp32: tokens differ from the CPU's")
    del cpu
    gc.collect()
    torch.cuda.empty_cache()
    return (medium["cache_append_rows_ragged"], q8_launches,
            medium["encoder_block_tail_q8"])


def routed(cfg, B: int, T: int, S: int, route: str) -> int:
    """1 when multi_head_attention sends a (B, T) query over S keys to
    `route` under cfg.attn_backend, else 0."""
    import torch

    from whisper_tpu_torch.ops.attention import _route
    q = torch.empty((B, T, cfg.n_heads, cfg.head_dim), device="meta")
    k = torch.empty((B, cfg.n_heads, S, cfg.head_dim), device="meta")
    return int(_route(q, k, cfg.attn_backend) == route)


def flash_per_fill(cfg, slots: int, p_pad: int) -> int:
    """Flash launches of one batched prefill of p_pad positions over the
    slot batch, as multi_head_attention routes them: per decoder layer,
    the self read (p_pad keys) and the cross read (n_audio_ctx keys)."""
    return cfg.n_text_layers * sum(routed(cfg, slots, p_pad, s, "flash")
                                   for s in (p_pad, cfg.n_audio_ctx))


def engine_traffic(cfg, n: int, seed: int) -> list:
    """n requests: the bench's synthetic clips cut to 5, 10, 20 and 30 s in
    turn; every fourth carries prev_tokens of 20 or 120 ids in turn (the 32
    and 128 prompt buckets beside the plain prompt's 8); two take
    language="auto"."""
    clips = bench_audio(cfg, n)
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        kw = {}
        if i % 4 == 3:
            kw["prev_tokens"] = rng.randint(
                220, 50_000, size=(20, 120)[(i // 4) % 2]).tolist()
        if i in (1, n // 2 + 1):
            kw["language"] = "auto"
        reqs.append((clips[i][:cfg.sample_rate * (5, 10, 20, 30)[i % 4]], kw))
    return reqs


def continuous_run(engine, reqs: list, kernels: dict, label: str, card: str
                   ) -> tuple:
    """One drive of the engine through submit, step and run_until_idle,
    every launch count set to 0 just before it and read just after it.
    Requests arrive ARRIVALS at a time before every ARRIVALS-th step, so
    they join beside live slots, slots free up raggedly, and the fills
    reach the 8, 32 and 128 prompt buckets. The host clock times each fill
    between two synchronisations. Fails unless every request is delivered
    with its SOT prompt and ids inside the vocab, and the fills reach
    those three buckets, all but the first beside a live slot. Returns
    (the phase line, a function that drives the same traffic again, and
    each request's tokens in submission order)."""
    import torch

    from whisper_tpu_torch import serving_continuous
    from whisper_tpu_torch.tokenizer import build_prompt
    cfg = engine.cfg
    fill_s, steps, beside_live, detects = [0.0], [0], [0], [0]
    fill, step_device = engine._fill_free_slots, engine.step_device

    def timed_fill():
        live = any(s is not None for s in engine._slots)
        fills = sum(engine.fill_buckets.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        fill()
        torch.cuda.synchronize()
        fill_s[0] += time.perf_counter() - t
        if live and sum(engine.fill_buckets.values()) > fills:
            beside_live[0] += 1

    def counted_step(k: int = 1):
        steps[0] += k
        step_device(k)

    engine._fill_free_slots, engine.step_device = timed_fill, counted_step
    detect = serving_continuous.detect_language

    def counted_detect(*args):
        detects[0] += 1
        return detect(*args)

    def run():
        rids = []
        for i, (audio, kw) in enumerate(reqs):
            rids.append(engine.submit(audio, **kw))
            if i % ARRIVALS == ARRIVALS - 1:
                for _ in range(ARRIVALS):
                    engine.step()
        out = engine.run_until_idle()
        torch.cuda.synchronize()
        return rids, out

    engine.warmup()
    fill_s[0], steps[0], beside_live[0] = 0.0, 0, 0
    for fn in kernels.values():
        fn.launches = 0
    serving_continuous.detect_language = counted_detect
    try:
        t0 = time.perf_counter()
        rids, out = run()
        wall = time.perf_counter() - t0
    finally:
        serving_continuous.detect_language = detect
    launches = {name: fn.launches for name, fn in kernels.items()}
    fills = sum(engine.fill_buckets.values())
    generated = 0
    for rid, (_, kw) in zip(rids, reqs):
        require(rid in out, f"{label}: request {rid} not delivered")
        ids = out[rid]
        want = build_prompt(cfg, "en", prev_tokens=kw.get("prev_tokens", ()))
        P = len(want)
        if kw.get("language") == "auto":   # any language token at its place
            want[P - 3] = ids[P - 3]
            require(cfg.first_language_token <= ids[P - 3]
                    < cfg.first_language_token + cfg.n_languages,
                    f"{label}: request {rid} has no language token")
        require(ids[:P] == want, f"{label}: request {rid} does not start "
                                 f"with its SOT prompt")
        require(all(0 <= t < cfg.vocab_size for t in ids),
                f"{label}: request {rid} has ids outside the vocab")
        generated += len(ids) - P
    line = {"phase": label, "model": cfg.name, "dtype": cfg.compute_dtype,
            "slots": engine.B, "requests": len(reqs), "max_new": engine.max_new,
            "sync_every": engine.sync_every, "arrivals": ARRIVALS,
            "attn_backend": cfg.attn_backend,
            "wall_s": wall, "engine_steps": steps[0], "fills": fills,
            "detect_language_calls": detects[0],
            "fills_beside_live": beside_live[0],
            "fill_buckets": dict(engine.fill_buckets), "fill_s": fill_s[0],
            "generated_tokens": generated, "tokens_per_s": generated / wall,
            "mean_step_ms": 1e3 * (wall - fill_s[0]) / steps[0],
            "queue_stats": engine.queue_stats(), "launches": launches,
            "card": card}
    require({8, 32, 128} <= set(engine.fill_buckets),
            f"{label}: fills reached the buckets {dict(engine.fill_buckets)}, "
            f"not 8, 32 and 128")
    require(beside_live[0] == fills - 1,
            f"{label}: {beside_live[0]} of {fills} fills beside a live slot")
    return line, lambda: run()[1], [out[rid] for rid in rids]


def read_route(cfg, B: int, T: int, S: int, int8: bool) -> str:
    """Where a read of T queries over S cache slots goes under
    cfg.attn_backend: "q8" (decode_attention_q8_bh) for an int8 cache that
    multi_head_attention_quant sends to its kernel, else the switch's
    route ("flash", "decode" or "reference"), after the dequantization of
    an int8 cache."""
    from whisper_tpu_torch.ops.attention import _q8_kernel_route
    if int8 and _q8_kernel_route(T, S, False, cfg.attn_backend):
        return "q8"
    return ("flash" if routed(cfg, B, T, S, "flash") else
            "decode" if routed(cfg, B, T, S, "decode") else "reference")


def check_engine_launches(line: dict, engine, cfg, flash_per_encode: int
                          ) -> dict:
    """Emit the engine's phase line and hold its launch counts to the path
    under cfg.attn_backend and its caches: one ragged append per engine
    step and no scalar append; per fill, the encoder's tail launches (the
    int8 form under encoder_mlp_quant in bf16), or with `flash_per_encode`
    its flash launches (the tail off), and the prefill's
    flash launches by the switch; for every layer's T==1 cross read at
    each step, and for detect_language's self (one of 64 slots) and cross
    reads, the kernel `read_route` names: decode_attention_bh ("pallas")
    or decode_attention_q8_bh (an fp32 int8 cross cache under
    "pallas_interpret"; a bf16 engine step reads an int8 cross cache
    scale-commuted, with no kernel); no other decode kernel and no fused
    step. Returns the counts."""
    import torch

    from whisper_tpu_torch.decode import _cache_slots
    from whisper_tpu_torch.models.whisper import compute_dtype
    n = line["launches"]
    fills, steps = line["fills"], line["engine_steps"]
    bf16 = compute_dtype(cfg) != torch.float32
    tail = cfg.n_audio_layers * fills if flash_per_encode == 0 else 0
    q8_tail = bool(tail and bf16 and cfg.encoder_mlp_quant)
    flash = flash_per_encode * fills + sum(
        count * flash_per_fill(cfg, engine.B, p_pad)
        for p_pad, count in engine.fill_buckets.items())
    B, Sx = engine.B, cfg.n_audio_ctx
    cross8 = bool(cfg.kv_cache_quant or cfg.cross_kv_quant)
    self8 = bool(cfg.kv_cache_quant or (cfg.self_kv_quant and bf16))
    step = "commuted" if cross8 and bf16 else read_route(cfg, B, 1, Sx,
                                                         cross8)
    detect = (read_route(cfg, B, 1, _cache_slots(cfg, 1), self8),
              read_route(cfg, B, 1, Sx, cross8))

    def reads(route: str) -> int:
        return cfg.n_text_layers * (steps * (step == route)
                                    + line["detect_language_calls"]
                                    * sum(r == route for r in detect))

    line["expected"] = {"cache_append_rows_ragged": steps,
                        "cache_append_rows": 0,
                        "encoder_block_tail": 0 if q8_tail else tail,
                        "encoder_block_tail_q8": tail if q8_tail else 0,
                        "flash_attention": flash, **NO_DECODE,
                        "decode_attention_bh": reads("decode"),
                        "decode_attention_q8_bh": reads("q8"),
                        "decode_attention_q8": 0, "fused_decoder_step": 0}
    emit(line)
    for name, want in line["expected"].items():
        require(n[name] == want, f"{line['phase']}: {name} launches "
                                 f"{n[name]} != {want}")
    return n


def continuous_identity(params, card: str) -> None:
    """Whisper-tiny through the engine on the card. (a) fp32 and bf16: one
    request alone and the same request in a crowd of 8 slots, arriving
    third while two others are mid-decode, give identical tokens. (b) fp32:
    4 requests through the engine give greedy_decode's tokens on the same
    4 clips, without rules and with suppression rules. Any difference
    fails, after a line with the first differing position and the logit
    margin there."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.decode_rules import DecodeOptions
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher
    clips = bench_audio(get_config("tiny"), 8)
    max_new = 24
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("tiny").replace(compute_dtype=dtype)
        solo = ContinuousBatcher(params, cfg, max_slots=8, max_new=max_new)
        r = solo.submit(clips[5])
        ref = solo.run_until_idle()[r]
        crowd = ContinuousBatcher(params, cfg, max_slots=8, max_new=max_new)
        for i in (0, 1):
            crowd.submit(clips[i])
        for _ in range(6):
            crowd.step()
        mine = crowd.submit(clips[5])
        for i in (2, 3, 4, 6, 7):
            crowd.submit(clips[i])
        got = crowd.run_until_idle()[mine]
        identity_line("solo_vs_crowd", dtype, got, ref, params, cfg, clips[5])
        del solo, crowd

    cfg = get_config("tiny").replace(compute_dtype="float32")
    pipe = WhisperPipeline.from_params(params, cfg, device="cuda",
                                       quant="off")
    for name, opts in (("no_rules", None),
                       ("suppress", DecodeOptions(suppress_blank=True,
                                                  suppress_tokens=(100, 200)))):
        eng = ContinuousBatcher(params, cfg, max_slots=4, max_new=max_new,
                                opts=opts)
        rids = [eng.submit(c) for c in clips[:4]]
        out = eng.run_until_idle()
        res = pipe.transcribe_batch(clips[:4], max_new=max_new, opts=opts)
        toks, lens = res.tokens.cpu(), res.lengths.cpu()
        for b, rid in enumerate(rids):
            identity_line(f"engine_vs_greedy_{name}_{b}", "float32", out[rid],
                          toks[b, :int(lens[b])].tolist(), params, cfg,
                          clips[b])
        del eng
    del pipe
    torch.cuda.empty_cache()


def identity_line(case: str, dtype: str, got: list, want: list, params, cfg,
                  clip) -> None:
    """Emit one continuous_identity line; on a difference, also the first
    differing position and the logit margin there (the model's logit of
    `got`'s token minus that of `want`'s, teacher-forced on the common
    prefix), then fail."""
    same = got == want
    line = {"phase": "continuous_identity", "case": case, "dtype": dtype,
            "identical": same, "tokens": len(got)}
    if not same:
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        line["first_diff"] = i
        if i < min(len(got), len(want)):
            lg = prefix_logits(params, cfg, clip, want[:i])
            line["logit_margin"] = float(lg[got[i]] - lg[want[i]])
    emit(line)
    require(same, f"continuous_identity {case} {dtype}: tokens differ")


def prefix_logits(params, cfg, clip, prefix: list):
    """The last position's logits of one teacher-forced decoder pass over
    `prefix`, on the card, in cfg's dtype."""
    import torch

    from whisper_tpu_torch import weights
    from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decode import encode
    from whisper_tpu_torch.models.whisper import (
        compute_dtype,
        decoder_forward,
        full_fp32,
        init_kv_cache,
        precompute_cross_kv,
    )
    dtype = compute_dtype(cfg)
    p = weights.to_device(params, "cuda",
                          None if dtype == torch.float32 else dtype)
    wav = torch.from_numpy(pad_or_trim(clip, cfg.n_samples)[None]).cuda()
    enc = encode(p, cfg, log_mel_spectrogram(wav, cfg))
    with torch.inference_mode(), full_fp32(dtype == torch.float32):
        cross = precompute_cross_kv(p, cfg, enc)
        cache = init_kv_cache(cfg, 1, dtype, cfg.n_text_ctx, "cuda")
        logits, _ = decoder_forward(p, cfg, torch.tensor([prefix]).cuda(), 0,
                                    cache, cross)
    return logits[0, -1].float().cpu()


def profile_engine(run, wall_s: float, label: str, card: str) -> None:
    """One more drive of the engine's traffic under torch.profiler: device
    time by kernel and the busy share of the unprofiled wall."""
    prof = profiled(run)
    kernels, device_ms = device_kernels(prof)
    emit({"phase": "profile_engine_device_time", "engine": label,
          "device_ms": device_ms, "unprofiled_wall_ms": 1e3 * wall_s,
          "device_busy_share": device_ms / (1e3 * wall_s), "card": card})
    for e in kernels[:20]:
        emit({"phase": "profile_engine_kernel", "engine": label,
              "kernel": e.key[:120], "device_ms": e.self_device_time_total / 1e3,
              "count": e.count})


def profiled(run):
    import torch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
    return prof


def device_kernels(prof) -> tuple[list, float]:
    """(device events by self time, descending; their total ms)."""
    from torch.autograd import DeviceType
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return kernels, sum(e.self_device_time_total for e in kernels) / 1e3


def beam_options(cfg, width: int):
    """Beam search with EOT suppressed by the rules: fixed work, as the
    bench's logit bias gives greedy (beam search takes no logit bias)."""
    from whisper_tpu_torch.decode_rules import DecodeOptions
    return DecodeOptions(beam_size=width, suppress_blank=False,
                         suppress_tokens=(cfg.eot_token,))


def beam_main_path(pipe, kernels: dict, batch: int, encoder: dict,
                   card: str, profile: bool = False) -> dict:
    """Beam search (width BEAM) over `batch` bench clips through
    pipe.transcribe_batch, GEN_TOKENS tokens: a warm-up, then three runs,
    each with every launch count set to 0 just before it; the counts of
    the last, the median wall and the peak device memory. Fails unless the
    counts are the path's: `encoder`'s (the tail or flash per encoder
    layer), the prefill's flash reads over batch x BEAM rows where the
    size gate sends them, one append per loop step, no fused step and no
    decode kernel; and unless the output is sane. Then beam 1
    (beam_decode) must give greedy_decode's tokens bit for bit on the same
    encoder output. With `profile`, one more run under torch.profiler
    (device time by kernel). Returns the phase line."""
    import torch

    from whisper_tpu_torch.decode import beam_decode, greedy_decode
    cfg = pipe.cfg
    audio = bench_audio(cfg, batch)
    opts, max_new, P = beam_options(cfg, BEAM), GEN_TOKENS - 1, 4

    def run():
        res = pipe.transcribe_batch(audio, max_new=max_new, opts=opts)
        torch.cuda.synchronize()
        return res

    run()                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in kernels.items()}
    rows = batch * BEAM
    prefill_flash = cfg.n_text_layers * sum(
        routed(cfg, rows, P, S, "flash") for S in (P, cfg.n_audio_ctx))
    expect = {"encoder_block_tail": encoder.get("encoder_block_tail", 0),
              "flash_attention": encoder.get("flash_attention", 0)
              + prefill_flash,
              "cache_append_rows": max_new, "cache_append_rows_ragged": 0,
              "fused_decoder_step": 0, "decode_attention_q8_bh": 0,
              "decode_attention_q8": 0, **NO_DECODE}
    toks = res.tokens.cpu()
    gen = toks[:, P:]
    median = float(np.median(walls))
    line = {"phase": "beam_main_path", "model": cfg.name,
            "dtype": cfg.compute_dtype, "batch": batch, "beam": BEAM,
            "decode_rows": rows, "gen_tokens": GEN_TOKENS, "walls_s": walls,
            "median_wall_s": median,
            "audio_s_per_wall_s": batch * cfg.chunk_length_s / median,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "expected": expect, "card": card}
    for name, n in expect.items():
        require(launches[name] == n,
                f"beam {cfg.name}: {name} launches {launches[name]} != {n}")
    require(tuple(toks.shape) == (batch, P + GEN_TOKENS),
            f"beam tokens shape {tuple(toks.shape)}")
    require(bool((gen != cfg.eot_token).all()), "beam: EOT while suppressed")
    require(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
            "beam: token ids outside the vocab")
    require(bool(torch.isfinite(res.sum_logprobs).all()),
            "beam: non-finite sum_logprobs")

    # beam 1 against greedy, on one encoder output
    with torch.inference_mode():
        enc = pipe._encode_audio(audio)
        prompt = pipe.prompt(batch)
        one = beam_options(cfg, 1)
        g = greedy_decode(pipe.params, cfg, enc, prompt, max_new=max_new,
                          opts=one)
        b1 = beam_decode(pipe.params, cfg, enc, prompt, beam_size=1,
                         max_new=max_new, opts=one)
    line["beam1_equals_greedy"] = bool(torch.equal(g.tokens, b1.tokens))
    line["beam1_sum_logprob_max_abs_diff"] = float(
        (g.sum_logprobs - b1.sum_logprobs).abs().max())
    line["best_beam_minus_greedy_sum_logprob_mean"] = float(
        (res.sum_logprobs - g.sum_logprobs).mean())
    emit(line)
    require(line["beam1_equals_greedy"],
            f"beam {cfg.name}: beam 1 differs from greedy on the card")
    if profile:
        model = f"{cfg.name}_beam{BEAM}"
        events, device_ms = device_kernels(profiled(run))
        emit({"phase": "profile_device_time", "model": model,
              "device_ms": device_ms, "unprofiled_median_wall_ms":
              1e3 * median, "device_busy_share": device_ms / (1e3 * median),
              "card": card})
        for e in events[:20]:
            emit({"phase": "profile_kernel", "model": model,
                  "kernel": e.key[:120],
                  "device_ms": e.self_device_time_total / 1e3,
                  "count": e.count})
    return line


def beam_fp32_parity(params, clips: np.ndarray, kernels: dict,
                     card: str) -> None:
    """Tiny fp32, len(clips) clips x beam BEAM, BEAM_PARITY_TOKENS tokens,
    on the card and on the CPU (plain versions) from the same params: the
    tokens identical, the best beams' sum_logprobs within
    BEAM_LOGPROB_ATOL. Then the same with the int8 cross cache, where
    every layer's cross read at every loop step is one
    decode_attention_q8_bh launch."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    max_new = BEAM_PARITY_TOKENS - 1
    for quant in (False, True):
        cfg = get_config("tiny").replace(cross_kv_quant=quant)
        opts = beam_options(cfg, BEAM)
        runs = {}
        for device in ("cuda", "cpu"):
            pipe = WhisperPipeline.from_params(params, cfg, dtype="float32",
                                               device=device, quant="off")
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = pipe.transcribe_batch(clips, max_new=max_new, opts=opts)
            runs[device] = (res.tokens.cpu(), res.sum_logprobs.cpu(),
                            time.perf_counter() - t0,
                            {n: fn.launches for n, fn in kernels.items()})
            del pipe, res
            torch.cuda.empty_cache()
        gpu, cpu = runs["cuda"], runs["cpu"]
        launches = gpu[3]
        line = {"phase": "beam_fp32_parity", "quant": quant_flags(cfg),
                "batch": len(clips), "beam": BEAM, "max_new": max_new,
                "tokens_identical": bool(torch.equal(gpu[0], cpu[0])),
                "tokens": gpu[0].tolist(),
                "sum_logprobs_max_abs_err": float(
                    (gpu[1] - cpu[1]).abs().max()),
                "sum_logprob_atol": BEAM_LOGPROB_ATOL,
                "gpu_s": gpu[2], "cpu_s": cpu[2], "launches": launches,
                "card": card}
        emit(line)
        require(line["tokens_identical"],
                f"beam fp32 {quant_flags(cfg)}: tokens differ GPU vs CPU")
        require(line["sum_logprobs_max_abs_err"] < BEAM_LOGPROB_ATOL,
                f"beam fp32 sum_logprobs differ by "
                f"{line['sum_logprobs_max_abs_err']}")
        q8 = cfg.n_text_layers * max_new if quant else 0
        require(launches["decode_attention_q8_bh"] == q8
                and launches["cache_append_rows"] == max_new,
                f"beam fp32 {quant_flags(cfg)}: launches {launches}")


def sampling(pipe, params, kernels: dict, card: str) -> None:
    """Temperature sampling on the card. (a) Tiny b32 bf16 at SAMPLE_T
    through transcribe_batch with the non-speech suppression and EOT
    banned: the same generator seed gives the same tokens twice, another
    seed other tokens, and no drawn token is one whose logit the bias or
    the rules masked. (b) The tiny engine with BATCH slots at
    ENGINE_SAMPLE_T over SAMPLE_ENGINE_REQUESTS requests, each with its
    own seed, EOT and the non-speech set suppressed: a request's tokens
    equal its run alone in an engine of the same slots (the same GEMM
    shapes), another seed gives others, no generated token is masked, and
    the engine's noise is finite over the run's (seed, position) rows at
    the full vocabulary and at every uniform its hash can give."""
    import torch

    from whisper_tpu_torch.decode import gumbel_noise
    from whisper_tpu_torch.decode_rules import DecodeOptions
    from whisper_tpu_torch.serving_continuous import (
        ContinuousBatcher,
        hashed_gumbel,
    )
    from whisper_tpu_torch.tokenizer import build_prompt
    cfg = pipe.cfg
    audio = bench_audio(cfg, BATCH)
    bias = torch.zeros(cfg.vocab_size, device="cuda")
    bias[cfg.eot_token] = -1e9
    opts = pipe.make_options(suppress_nonspeech=True, temperature=SAMPLE_T)

    def run(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        res = pipe.transcribe_batch(audio, max_new=GEN_TOKENS - 1,
                                    logit_bias=bias, opts=opts, generator=g)
        torch.cuda.synchronize()
        return res.tokens.cpu()

    a = run(0)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    b = run(0)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    c = run(1)
    gen = a[:, 4:]
    masked = torch.tensor(sorted(set(opts.suppress_tokens)
                                 | {cfg.eot_token}))
    drawn_masked = int(torch.isin(gen, masked).sum()
                       + (gen >= cfg.timestamp_begin).sum()
                       + (gen[:, 0] == 220).sum())
    line = {"phase": "sampling", "model": cfg.name,
            "dtype": cfg.compute_dtype, "batch": BATCH,
            "temperature": SAMPLE_T, "gen_tokens": GEN_TOKENS,
            "same_seed_identical": bool(torch.equal(a, b)),
            "other_seed_differs": not torch.equal(a, c),
            "other_seed_token_agreement": float(
                (a[:, 4:] == c[:, 4:]).float().mean()),
            "masked_tokens_drawn": drawn_masked,
            "distinct_tokens": int(gen.unique().numel()), "wall_s": wall,
            "launches": launches, "card": card}
    emit(line)
    require(line["same_seed_identical"], "sampling: seed 0 twice differs")
    require(line["other_seed_differs"], "sampling: seeds 0 and 1 agree")
    require(drawn_masked == 0, f"sampling: {drawn_masked} masked draws")
    require(launches["cache_append_rows"] == GEN_TOKENS - 1
            and launches["encoder_block_tail"] == cfg.n_audio_layers,
            f"sampling: launches {launches}")

    ecfg = cfg.replace(compute_dtype="bfloat16")
    banned = set(opts.suppress_tokens) | {cfg.eot_token}
    eopts = DecodeOptions(temperature=ENGINE_SAMPLE_T, suppress_blank=False,
                          suppress_tokens=tuple(sorted(banned)))
    clips = bench_audio(cfg, SAMPLE_ENGINE_REQUESTS)

    def engine():
        return ContinuousBatcher(params, ecfg, max_slots=BATCH,
                                 max_new=SAMPLE_ENGINE_MAX_NEW, opts=eopts)

    crowd = engine()
    for fn in kernels.values():
        fn.launches = 0
    rids = [crowd.submit(clip, seed=1000 + i) for i, clip in enumerate(clips)]
    t0 = time.perf_counter()
    out = crowd.run_until_idle()
    torch.cuda.synchronize()
    crowd_wall = time.perf_counter() - t0
    ragged = kernels["cache_append_rows_ragged"].launches
    del crowd
    P = len(build_prompt(cfg))
    gen = [out[r][P:] for r in rids]
    engine_masked = sum(len(banned & set(g)) + sum(t > cfg.eot_token
                                                   for t in g) for g in gen)
    seeds = torch.arange(1000, 1000 + SAMPLE_ENGINE_REQUESTS, device="cuda")
    noise_finite = all(
        bool(torch.isfinite(hashed_gumbel(
            seeds, torch.full_like(seeds, p), cfg.vocab_size)).all())
        for p in range(P, P + SAMPLE_ENGINE_MAX_NEW + 1))
    u = torch.arange(1 << 24, device="cuda", dtype=torch.int32).float()
    grid_finite = bool(torch.isfinite(gumbel_noise(u * 2.0 ** -24)).all())
    del u
    solo_same, solo_other = [], []
    solo = engine()
    for i in (0, SAMPLE_ENGINE_REQUESTS - 1):   # the first and a late joiner
        for seed, same in ((1000 + i, True), (7, False)):
            r = solo.submit(clips[i], seed=seed)      # alone in the engine
            got = solo.run_until_idle()[r]
            (solo_same if same else solo_other).append(
                (got == out[rids[i]]) == same)
    del solo
    line = {"phase": "sampling_engine", "model": cfg.name,
            "dtype": "bfloat16", "slots": BATCH,
            "requests": SAMPLE_ENGINE_REQUESTS,
            "max_new": SAMPLE_ENGINE_MAX_NEW, "temperature": ENGINE_SAMPLE_T,
            "wall_s": crowd_wall, "ragged_launches": ragged,
            "solo_equals_crowd": solo_same, "other_seed_differs": solo_other,
            "masked_tokens_drawn": engine_masked,
            "gen_lengths": sorted({len(g) for g in gen}),
            "noise_finite": noise_finite, "uniform_grid_finite": grid_finite,
            "card": card}
    emit(line)
    require(engine_masked == 0,
            f"sampling engine: {engine_masked} masked draws")
    require(line["gen_lengths"] == [SAMPLE_ENGINE_MAX_NEW + 1],
            f"sampling engine: EOT banned, lengths {line['gen_lengths']}")
    require(noise_finite and grid_finite,
            "sampling engine: non-finite Gumbel noise on the card")
    require(all(solo_same), "sampling engine: a request's tokens depend on "
                            "its companions")
    require(all(solo_other), "sampling engine: another seed, same tokens")
    require(ragged > 0, "sampling engine: no ragged append launched")
    torch.cuda.empty_cache()


def cli_beam(clip: np.ndarray, card: str) -> None:
    """The CLI from an npz that the port's save_npz wrote (tiny, seed 7):
    beam search with the timestamp and suppression rules, then sampling
    with a seed. Prints each run's tokens; fails unless both exit 0."""
    import io

    from whisper_tpu_torch import cli, get_config, weights
    cfg = get_config("tiny")
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "tiny_seed7.npz")
        weights.save_npz(npz, weights.init_params(cfg, 7))
        wav_path = os.path.join(tmp, "clip.wav")
        x = (clip[:cfg.sample_rate * 5] * 32000).astype(np.int16)
        with wave.open(wav_path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg.sample_rate)
            w.writeframes(x.tobytes())
        for flags in (["--beam", str(BEAM), "--timestamps",
                       "--suppress-nonspeech"],
                      ["--temperature", str(SAMPLE_T), "--seed", "3"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--weights", npz, "--audio", wav_path,
                               "--max-new", "24", *flags])
            tokens = [ln.split(":", 1)[1].strip()
                      for ln in out.getvalue().splitlines()
                      if ln.startswith("tokens:")]
            emit({"phase": "cli_beam", "flags": flags, "rc": rc,
                  "tokens": tokens[0] if tokens else None, "card": card})
            require(rc == 0 and tokens, f"cli {flags} returned {rc}")


def longform_clip(seconds: float, rate: int = 16_000, seed: int = 0
                  ) -> np.ndarray:
    """A long clip: a 0.3-amplitude tone whose pitch steps every 5 s, plus
    noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * (200 + 40 * np.floor(t / 5)) * t)
            + 0.05 * rng.randn(t.size)).astype(np.float32)


def write_wav(path: str, x: np.ndarray, rate: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def greedy_steps(res, P: int, max_new: int, eot: int) -> int:
    """The T==1 steps greedy decoding ran for row 0 of a DecodeResult: the
    loop checks for a finished batch every POLL_EVERY steps
    (decode._greedy_loop), so a row whose EOT came at step e stops at the
    next multiple of POLL_EVERY after it; none if the first pick was EOT."""
    from whisper_tpu_torch.decode import POLL_EVERY
    gen = res.tokens[0, P:P + 1 + max_new].tolist()
    if gen[0] == eot:
        return 0
    if eot not in gen[1:]:
        return max_new
    e = gen[1:].index(eot)
    return min(max_new, -(-(e + 1) // POLL_EVERY) * POLL_EVERY)


@contextlib.contextmanager
def longform_recorder(pipe):
    """Records what a long-form transcription ran: each window's offset,
    prompt length and DecodeResult (through the pipeline module's
    decode_from_encoder), and the seconds spent in word alignment (the
    device synchronised around each call), of which those in its
    teacher-forced pass on the device (cross_attention_weights, with the
    copy of the probabilities to the host), in the median filter and in
    the DTW (numpy, on the host)."""
    import torch

    from whisper_tpu_torch import alignment
    from whisper_tpu_torch import pipeline as pl
    rec = {"offsets": [], "windows": [], "align_s": 0.0, "probs_s": 0.0,
           "median_s": 0.0, "dtw_s": 0.0}
    real_decode, real_align = pl.decode_from_encoder, pl.align_words
    real = {name: getattr(alignment, name) for name in
            ("cross_attention_weights", "median_filter", "dtw_path")}
    real_window = pipe.transcribe_window

    def decode(*a, **kw):
        res = real_decode(*a, **kw)
        rec["windows"].append((a[3].shape[1], res))
        return res

    def align(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_align(*a, **kw)
        torch.cuda.synchronize()
        rec["align_s"] += time.perf_counter() - t
        return out

    def timed(name, key, post=lambda x: x):
        def call(*a, **kw):
            t = time.perf_counter()
            out = post(real[name](*a, **kw))
            rec[key] += time.perf_counter() - t
            return out
        return call

    def window(*a, **kw):
        rec["offsets"].append(kw.get("window_offset_s", 0.0))
        return real_window(*a, **kw)

    pl.decode_from_encoder, pl.align_words = decode, align
    alignment.cross_attention_weights = timed(
        "cross_attention_weights", "probs_s", lambda x: x.cpu())
    alignment.median_filter = timed("median_filter", "median_s")
    alignment.dtw_path = timed("dtw_path", "dtw_s")
    pipe.transcribe_window = window
    try:
        yield rec
    finally:
        pl.decode_from_encoder, pl.align_words = real_decode, real_align
        for name, fn in real.items():
            setattr(alignment, name, fn)
        del pipe.transcribe_window


def longform_transcribe(pipe, audio: np.ndarray):
    """The long-form drive: timestamps (seek by the last closed segment),
    conditioning on the previous window, word timestamps."""
    return pipe.transcribe(audio, max_new=LONGFORM_MAX_NEW,
                           opts=pipe.make_options(timestamps=True),
                           condition_on_previous=True, word_timestamps=True)


def longform_path(pipe, kernels: dict, card: str, profile: bool,
                  label: str = "longform_turbo") -> dict:
    """Long-form transcription through WhisperPipeline.transcribe on a
    LONGFORM_S clip: a warm-up, then one run with every launch count set to
    0 just before it and read just after. The encoder's tail runs once a
    layer a window, the append once a greedy step (greedy_steps of each
    window's result), and flash once a decoder layer for each prefill read
    that multi_head_attention routes to it (the cross read of a prompt
    lengthened by the previous window's text can cross the "auto" gate);
    nothing else launches. Returns the phase line."""
    import torch

    from whisper_tpu_torch.decode import _cache_slots
    cfg = pipe.cfg
    audio = longform_clip(LONGFORM_S)
    longform_transcribe(pipe, audio)                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with longform_recorder(pipe) as rec:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        r = longform_transcribe(pipe, audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
    n = len(rec["windows"])
    steps = [greedy_steps(res, P, LONGFORM_MAX_NEW, cfg.eot_token)
             for P, res in rec["windows"]]
    expect = {name: 0 for name in kernels}
    expect["encoder_block_tail"] = cfg.n_audio_layers * n
    expect["cache_append_rows"] = sum(steps)
    expect["flash_attention"] = cfg.n_text_layers * sum(
        routed(cfg, 1, P, s, "flash") for P, _ in rec["windows"]
        for s in (_cache_slots(cfg, P + 1 + LONGFORM_MAX_NEW),
                  cfg.n_audio_ctx))
    line = {"phase": label, "model": cfg.name,
            "dtype": cfg.compute_dtype, "audio_s": LONGFORM_S,
            "max_new": LONGFORM_MAX_NEW, "windows": n,
            "seek_offsets_s": rec["offsets"],
            "prompt_lens": [P for P, _ in rec["windows"]],
            "steps": steps, "segments": len(r.segments or ()),
            "words": len(r.words or ()), "wall_s": wall,
            "audio_s_per_wall_s": LONGFORM_S / wall,
            "align_ms": 1e3 * rec["align_s"],
            "align_probs_ms": 1e3 * rec["probs_s"],
            "align_median_ms": 1e3 * rec["median_s"],
            "align_dtw_ms": 1e3 * rec["dtw_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "expected_launches": expect,
            "card": card}
    emit(line)
    require(launches == expect, f"longform {cfg.name}: launches {launches} "
                                f"!= {expect}")
    require(n >= 3 and r.tokens.count(cfg.sot_token) == n,
            f"longform {cfg.name}: {n} windows")
    require(len(rec["offsets"]) == n and rec["offsets"][0] == 0.0
            and all(b - a >= 1.0 - 1e-9 for a, b in
                    zip(rec["offsets"], rec["offsets"][1:])),
            f"longform {cfg.name}: seek offsets {rec['offsets']}")
    require(bool(r.words) and all(0.0 <= w.start <= w.end
                                  for w in r.words),
            f"longform {cfg.name}: no word timings, or times out of order")
    if profile:
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            longform_transcribe(pipe, audio)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        emit({"phase": f"profile_{label}", "walls_s": walls,
              "card": card})
    return line


def longform_fp32_parity(params, card: str) -> None:
    """Tiny fp32 long-form on the card against the port on the CPU, from
    the same params: window offsets, tokens, text and segments equal; word
    times within one encoder frame (WORD_TIME_TOL), the number that
    differ reported."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    audio = longform_clip(LONGFORM_S, seed=1)
    runs = {}
    for device in ("cuda", "cpu"):
        pipe = WhisperPipeline.from_params(params, "tiny", dtype="float32",
                                           device=device, quant="off")
        with longform_recorder(pipe) as rec:
            t0 = time.perf_counter()
            r = longform_transcribe(pipe, audio)
            runs[device] = (r, time.perf_counter() - t0, rec["offsets"])
        del pipe
        torch.cuda.empty_cache()
    gpu, cpu = runs["cuda"][0], runs["cpu"][0]
    words_g, words_c = gpu.words or [], cpu.words or []
    diffs = [max(abs(a.start - b.start), abs(a.end - b.end))
             for a, b in zip(words_g, words_c)]
    line = {"phase": "longform_fp32_parity", "model": "tiny",
            "audio_s": LONGFORM_S, "windows":
            gpu.tokens.count(get_config("tiny").sot_token),
            "seek_offsets_s": runs["cuda"][2],
            "tokens_identical": gpu.tokens == cpu.tokens,
            "text_identical": gpu.text == cpu.text,
            "segments_identical": gpu.segments == cpu.segments,
            "words": len(words_g),
            "words_same_text": [w.word for w in words_g]
            == [w.word for w in words_c],
            "word_times_differing": sum(d > 0 for d in diffs),
            "word_time_max_abs_diff_s": max(diffs, default=0.0),
            "gpu_s": runs["cuda"][1], "cpu_s": runs["cpu"][1], "card": card}
    emit(line)
    require(line["tokens_identical"] and line["text_identical"]
            and line["segments_identical"] and line["words_same_text"]
            and runs["cuda"][2] == runs["cpu"][2],
            "longform fp32: the card's transcript differs from the CPU's")
    require(len(words_g) > 0 and line["word_time_max_abs_diff_s"]
            <= WORD_TIME_TOL, f"longform fp32: word times differ by "
                              f"{line['word_time_max_abs_diff_s']} s")


def speculative_phase(kernels: dict, card: str, profile: bool) -> dict:
    """Speculative decoding with medium at full width and depth as the
    target (weights drawn on the card), k = SPEC_K, SPEC_MAX_NEW tokens
    with EOT banned, batch 1: the tiny draft and medium as its own draft,
    in fp32 and bf16, the tokens required equal to the target's greedy,
    with the rounds, the acceptance rate and the decode wall against
    greedy's. Then spec_transcribe_window under attn_backend "pallas"
    (bf16 and fp32, the tiny draft): every prefill and verify read one
    flash_attention launch, every draft T==1 read one decode_attention_bh
    launch, each encoder layer one tail launch; the counts are required
    equal to those the round statistics imply. Returns the launches of
    the bf16 run."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.decode import greedy_decode
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.speculative import (
        spec_transcribe_window,
        speculative_decode,
    )
    mcfg, tcfg = get_config("medium"), get_config("tiny")
    mparams, tparams = card_init_params(mcfg, 0), card_init_params(tcfg, 1)
    clip = bench_audio(mcfg, 1)
    bias = torch.zeros(mcfg.vocab_size, device="cuda")
    bias[mcfg.eot_token] = -1e9
    reps = 3 if profile else 1

    def timed(fn):
        fn()                                        # warm-up
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out, min(walls)

    for dtype in ("float32", "bfloat16"):
        target = WhisperPipeline.from_params(mparams, mcfg, dtype=dtype,
                                             device="cuda", quant="off")
        draft = WhisperPipeline.from_params(tparams, tcfg, dtype=dtype,
                                            device="cuda", quant="off")
        t_enc = target._encode_audio(clip)
        prompt = target.prompt(1)
        ref, greedy_s = timed(lambda: greedy_decode(
            target.params, target.cfg, t_enc, prompt, max_new=SPEC_MAX_NEW,
            logit_bias=bias))
        for name, d in (("tiny", draft), ("medium_self", target)):
            d_enc = t_enc if d is target else d._encode_audio(clip)
            (res, stats), spec_s = timed(lambda: speculative_decode(
                target.params, target.cfg, d.params, d.cfg, t_enc, d_enc,
                prompt, max_new=SPEC_MAX_NEW, k=SPEC_K, logit_bias=bias,
                return_stats=True))
            same = bool(torch.equal(res.tokens, ref.tokens)
                        and torch.equal(res.lengths, ref.lengths))
            emit({"phase": "speculative", "target": "medium", "draft": name,
                  "dtype": dtype, "k": SPEC_K, "max_new": SPEC_MAX_NEW,
                  "tokens_equal_greedy": same, **stats,
                  "acceptance_rate": stats["accepted_drafts"]
                  / (stats["rounds"] * SPEC_K),
                  "spec_decode_s": spec_s, "greedy_decode_s": greedy_s,
                  "spec_over_greedy": spec_s / greedy_s,
                  "sum_logprobs_abs_diff": float(
                      (res.sum_logprobs - ref.sum_logprobs).abs().max()),
                  "card": card})
            require(same, f"speculative {dtype} with the {name} draft: "
                          f"tokens differ from the target's greedy")
            if name == "medium_self":
                require(stats["rounds"] == -(-SPEC_MAX_NEW // (SPEC_K + 1)),
                        f"speculative {dtype}: the target as its own draft "
                        f"took {stats['rounds']} rounds")
        del target, draft, t_enc
        torch.cuda.empty_cache()

    # under "pallas", through the user entry point, the tiny draft
    audio = clip[0, :mcfg.sample_rate * 20]
    Lt, Ld = mcfg.n_text_layers, tcfg.n_text_layers
    for dtype in ("bfloat16", "float32"):
        target = WhisperPipeline.from_params(
            mparams, mcfg.replace(attn_backend="pallas"), dtype=dtype,
            device="cuda", quant="off")
        draft = WhisperPipeline.from_params(
            tparams, tcfg.replace(attn_backend="pallas"), dtype=dtype,
            device="cuda", quant="off")
        spec_transcribe_window(target, draft, audio, max_new=SPEC_MAX_NEW,
                               k=SPEC_K)            # warm-up
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        r = spec_transcribe_window(target, draft, audio,
                                   max_new=SPEC_MAX_NEW, k=SPEC_K)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.items()}
        rounds, fills = r.timings["verify_rounds"], r.timings["draft_fills"]
        expect = {name: 0 for name in kernels}
        expect.update({
            "encoder_block_tail": mcfg.n_audio_layers + tcfg.n_audio_layers,
            "flash_attention": 2 * (Lt + Ld) + 2 * Lt * rounds,
            "decode_attention_bh": 2 * Ld * (SPEC_K * rounds + fills)})
        # greedy under "pallas" reads through decoder_step_ip's einsums at
        # every step, the verify through flash: equality is reported, not
        # required (the contract holds for the default backend, above)
        want = target.transcribe_window(audio, max_new=SPEC_MAX_NEW)
        emit({"phase": "speculative_pallas", "target": "medium",
              "draft": "tiny", "dtype": dtype, "k": SPEC_K,
              "rounds": rounds,
              "accepted_drafts": r.timings["accepted_drafts"],
              "draft_fills": fills, "tokens": len(r.tokens),
              "tokens_equal_greedy": r.tokens == want.tokens,
              "decode_s": r.timings["decode_s"], "launches": launches,
              "expected_launches": expect, "card": card})
        require(launches == expect, f"speculative_pallas {dtype}: launches "
                                    f"{launches} != {expect}")
        if dtype == "bfloat16":
            bf16_launches = launches
        del target, draft
    del mparams, tparams
    gc.collect()
    torch.cuda.empty_cache()
    return bf16_launches


def cli_longform(card: str) -> None:
    """The CLI in process: a CLI_LONG_S WAV at 22.05 kHz, read by the
    native loader and transcribed long-form with word timestamps, the
    previous window's text and the VAD gate, rendered as SRT; then a
    speculative run, small with the tiny draft, whose tokens are required
    equal to small's greedy run of the CLI."""
    import io

    from whisper_tpu_torch import cli, native
    from whisper_tpu_torch.config import get_config
    sot = get_config("tiny").sot_token

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        text = out.getvalue()
        lines = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
                 if ln.startswith("tokens:")]
        return rc, (json.loads(lines[0]) if lines else None), \
            time.perf_counter() - t0, text

    with tempfile.TemporaryDirectory() as tmp:
        long_wav = os.path.join(tmp, "long.wav")
        write_wav(long_wav, longform_clip(CLI_LONG_S, CLI_LONG_RATE, seed=2),
                  CLI_LONG_RATE)
        srt = os.path.join(tmp, "out.srt")
        rc, tokens, wall, _ = run([
            "--random-weights", "--audio", long_wav, "--max-new", "32",
            "--word-timestamps", "--output-format", "srt",
            "--condition-on-previous", "--vad-db", "-40", "--output", srt])
        rendered = open(srt, encoding="utf-8").read() if rc == 0 else ""
        emit({"phase": "cli_longform", "rc": rc, "audio_s": CLI_LONG_S,
              "rate": CLI_LONG_RATE, "native_loader": native.available(),
              "windows": tokens.count(sot) if tokens else 0,
              "srt_blocks": rendered.count(" --> "), "wall_s": wall,
              "card": card})
        require(rc == 0 and tokens and tokens.count(sot) >= 2
                and rendered.startswith("1\n00:00:"),
                f"cli long-form returned {rc}")
        short_wav = os.path.join(tmp, "short.wav")
        write_wav(short_wav, longform_clip(8.0, seed=3), 16_000)
        base = ["--model", "small", "--random-weights", "--audio", short_wav,
                "--max-new", "24"]
        rc_s, spec, spec_wall, text = run(base + ["--draft-model", "tiny"])
        rc_g, greedy, greedy_wall, _ = run(base)
        emit({"phase": "cli_speculative", "rc": rc_s, "rc_greedy": rc_g,
              "tokens_equal_greedy": spec == greedy,
              "timings": next((ln for ln in text.splitlines()
                               if ln.startswith("timings:")), None),
              "wall_s": spec_wall, "greedy_wall_s": greedy_wall,
              "card": card})
        require(rc_s == 0 and rc_g == 0 and spec and spec == greedy,
                "cli --draft-model: tokens differ from greedy's")


# ---------------------------------------------------------------------------
# the serving layer: the HTTP/SSE server, the dynamic batcher and
# the long-form driver on the card
# ---------------------------------------------------------------------------

def wav_bytes(x: np.ndarray, rate: int) -> bytes:
    """x as a mono 16-bit PCM WAV file's bytes."""
    import io
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def serve_mix(n: int, seed: int) -> list:
    """benchmarks/server_load.py's mix at SERVE_RATE: client i sends a
    SERVE_LONG_S file when i % SERVE_LONG_EVERY == SERVE_LONG_EVERY - 1,
    else a SERVE_SHORT_S clip. Returns [(WAV bytes, audio seconds)]."""
    out = []
    for i in range(n):
        secs = (SERVE_LONG_S if i % SERVE_LONG_EVERY == SERVE_LONG_EVERY - 1
                else SERVE_SHORT_S)
        out.append((wav_bytes(longform_clip(secs, SERVE_RATE, seed + i),
                              SERVE_RATE), secs))
    return out


def serve_request(port: int, body: bytes, sse: bool) -> dict:
    """One client's POST of a WAV body. SSE: the token events with their
    arrival times and the final event; else the JSON reply. Returns the
    status, Retry-After, the result, the streamed tokens, the seconds to
    the first token and between tokens, and the wall."""
    import urllib.error
    import urllib.request
    query = "?stream=1" if sse else ""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions{query}",
        data=body, headers={"Content-Type": "audio/wav"}, method="POST")
    out = {"sse": sse, "streamed": [], "stamps": []}
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out["status"] = r.status
            if not sse:
                out["result"] = json.loads(r.read())
            else:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    ev = json.loads(line[6:])
                    if "token" in ev:
                        out["streamed"].append(ev["token"])
                        out["stamps"].append(time.perf_counter() - t0)
                    else:
                        out["result"] = ev
    except urllib.error.HTTPError as e:
        out["status"] = e.code
        out["retry_after"] = e.headers.get("Retry-After")
        out["result"] = json.loads(e.read() or b"{}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def run_clients(port: int, bodies: list, sse: list) -> tuple[list, float]:
    """Every client in its own thread, released together; returns the
    replies in client order and the wall from the release to the last
    reply."""
    import concurrent.futures
    import threading
    gate = threading.Barrier(len(bodies) + 1)

    def client(i):
        gate.wait()
        return serve_request(port, bodies[i], sse[i])

    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        futs = [pool.submit(client, i) for i in range(len(bodies))]
        gate.wait()
        t0 = time.perf_counter()
        replies = [f.result() for f in futs]
    return replies, time.perf_counter() - t0


def http_json(port: int, path: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def served_windows(tokens: list, prompt: list, max_new: int, eot: int,
                   label: str) -> list:
    """The generated tokens of each window of a served result: every
    window is the SOT-led prompt, then the first pick and up to max_new
    more, ending at the cap or after an EOT. Fails on any other layout."""
    windows, i = [], 0
    while i < len(tokens):
        require(tokens[i:i + len(prompt)] == prompt,
                f"{label}: window {len(windows)} does not start with the "
                f"SOT prompt")
        i += len(prompt)
        gen = []
        while i < len(tokens) and len(gen) < max_new + 1:
            gen.append(tokens[i])
            i += 1
            if gen[-1] == eot:
                break
        windows.append(gen)
    return windows


def check_replies(replies: list, secs: list, cfg, max_new: int,
                  label: str) -> None:
    """Every reply 200 with the SOT prompt, a window per 30 s of audio
    (three for 75 s), and on SSE the streamed tokens equal to the final
    event's generated tokens."""
    from whisper_tpu_torch.tokenizer import build_prompt
    prompt = build_prompt(cfg)
    for i, (r, s) in enumerate(zip(replies, secs)):
        require(r["status"] == 200, f"{label}: client {i} got "
                                    f"{r['status']}: {r.get('result')}")
        wins = served_windows(r["result"]["tokens"], prompt, max_new,
                              cfg.eot_token, f"{label} client {i}")
        require(len(wins) == -(-int(s) // cfg.chunk_length_s),
                f"{label}: client {i} ({s} s) has {len(wins)} windows")
        if r["sse"]:
            require(r["result"].get("done") is True,
                    f"{label}: client {i} has no done event")
            require(r["streamed"] == [t for w in wins for t in w],
                    f"{label}: client {i}'s streamed tokens differ from the "
                    f"final event's")


def latency(replies: list, wall: float, audio_s: float) -> dict:
    """TTFT p50 and p95 and the median inter-token gap over the SSE
    clients; the completion wall, the aggregate audio RTFx over all
    clients, and the streamed tokens per second."""
    sse = [r for r in replies if r["sse"] and r["stamps"]]
    ttft = [r["stamps"][0] for r in sse]
    gaps = [b - a for r in sse for a, b in zip(r["stamps"], r["stamps"][1:])]
    tokens = sum(len(r["streamed"]) for r in sse)
    return {"ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None,
            "gap_p50_ms": float(np.median(gaps)) * 1e3 if gaps else None,
            "completion_wall_s": wall, "audio_s": audio_s,
            "audio_rtfx": audio_s / wall,
            "sse_tokens": tokens, "sse_tokens_per_s": tokens / wall}


class ServerProcess:
    """`python -m whisper_tpu_torch.server` in a process of its own, from
    this checkout, started at once; `wait()` waits for its startup line
    and its /healthz; `stop()` interrupts it and waits for it (killing it
    past a timeout)."""

    def __init__(self, args: list, log_dir: str, name: str):
        import queue
        import threading
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        self.name = name
        self.err_path = os.path.join(log_dir, f"{name}.err")
        self._err = open(self.err_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "whisper_tpu_torch.server", *args],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True)
        self.lines: queue.Queue = queue.Queue()
        self.out: list = []

        def read():
            for line in self.proc.stdout:
                self.out.append(line.rstrip())
                self.lines.put(line)
            self.lines.put(None)

        threading.Thread(target=read, daemon=True).start()

    def _fail(self, why: str):
        self.stop()
        with open(self.err_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"chip_smoke: server {self.name} {why}; stdout "
                           f"{self.out[-5:]}; stderr:\n{tail}")

    def wait(self, timeout: float = 300.0) -> tuple[int, str, float]:
        """(port, startup line, seconds from the spawn to /healthz)."""
        import queue
        import re
        import urllib.request
        deadline = self.t0 + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.1, deadline
                                                  - time.perf_counter()))
            except queue.Empty:
                self._fail("printed no startup line in time")
            if line is None:
                self._fail(f"exited with {self.proc.wait()}")
            m = re.match(r"serving \S+ on \S+:(\d+) \((.*)\)", line)
            if m:
                break
        port = int(m.group(1))
        while True:
            try:
                require(http_json(port, "/healthz")["status"] == "ok",
                        f"server {self.name}: /healthz not ok")
                break
            except OSError:
                if time.perf_counter() > deadline:
                    self._fail("never answered /healthz")
                time.sleep(0.1)
        return port, line.strip(), time.perf_counter() - self.t0

    def stop(self) -> None:
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._err.close()


def server_entry(card: str) -> None:
    """The daemon as a user starts it: tiny's random weights written by
    weights.to_flat_bin, then `python -m whisper_tpu_torch.server --model
    tiny --flat-bin ... --engine continuous --port 0 --max-batch 8` (the
    JAX server's defaults: bf16, quant="auto", warmup), beside the same
    binary with --max-queue 1 and with --engine dynamic, the three started
    together. The continuous server takes benchmarks/server_load.py's mix
    (8 clients at 22.05 kHz, 5 s clips, every 4th a 75 s file, half of
    them on SSE); the --max-queue 1 server a burst of 16 posts; the
    dynamic server 8 concurrent 30 s posts."""
    import torch

    from whisper_tpu_torch import get_config, native, weights
    cfg = get_config("tiny")
    # built here once, not by three servers at once
    require(native.available(), "the native library did not build")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny.bin")
        with open(path, "wb") as f:
            f.write(weights.to_flat_bin(weights.init_params(cfg, seed=0),
                                        cfg))
        base = ["--model", "tiny", "--flat-bin", path, "--port", "0",
                "--host", "127.0.0.1", "--max-batch", "8"]
        new = ["--max-new", str(SERVE_MAX_NEW)]
        procs = {
            "continuous": ServerProcess(base + ["--engine", "continuous"]
                                        + new, tmp, "continuous"),
            # the default cap (195 tokens) keeps the 8 slots busy through
            # the burst
            "max_queue_1": ServerProcess(base + ["--engine", "continuous",
                                                 "--max-queue", "1"], tmp,
                                         "max_queue_1"),
            # a grace window wide enough to gather the 8 posts: each
            # handler decodes and resamples its 30 s WAV on the host
            # first (about 0.7 s of CPU a post), and on a loaded host the
            # posts reach the queue more than a second apart. A full batch
            # launches at once, so the width costs nothing once all 8 are in
            "dynamic": ServerProcess(base + ["--engine", "dynamic",
                                             "--max-wait-ms",
                                             str(DYNAMIC_WAIT_MS)] + new,
                                     tmp, "dynamic")}
        try:
            ports = {k: p.wait() for k, p in procs.items()}
            kind = torch.cuda.get_device_name(0)
            for name, (_, line, _) in ports.items():
                require("device=cuda" in line and kind in line,
                        f"server {name}: the startup line names no card: "
                        f"{line}")
            # the mix, half of the clients on SSE
            mix = serve_mix(8, seed=40)
            replies, wall = run_clients(ports["continuous"][0],
                                        [b for b, _ in mix],
                                        [i % 2 == 0 for i in range(8)])
            secs = [s for _, s in mix]
            check_replies(replies, secs, cfg, SERVE_MAX_NEW,
                          "server_entry")
            stats = http_json(ports["continuous"][0], "/v1/stats")
            require(stats["completed"] == stats["received"] == 8
                    and stats["failed"] == 0 and stats["in_flight"] == 0,
                    f"server_entry: /v1/stats {stats}")
            # the admission bound
            clip = wav_bytes(longform_clip(SERVE_SHORT_S, SERVE_RATE, 7),
                             SERVE_RATE)
            burst, burst_wall = run_clients(ports["max_queue_1"][0],
                                            [clip] * 16, [False] * 16)
            codes = [r["status"] for r in burst]
            n503 = sum(c == 503 and r.get("retry_after") == "1"
                       for c, r in zip(codes, burst))
            require(n503 >= 1 and n503 + codes.count(200) == 16,
                    f"server_entry: the --max-queue 1 burst gave {codes}")
            # the dynamic batcher
            long30 = [wav_bytes(longform_clip(30.0, SERVE_RATE, 60 + i),
                                SERVE_RATE) for i in range(8)]
            dyn, dyn_wall = run_clients(ports["dynamic"][0], long30,
                                        [False] * 8)
            check_replies(dyn, [30.0] * 8, cfg, SERVE_MAX_NEW,
                          "server_entry dynamic")
            sizes = [r["result"]["batch_size"] for r in dyn]
            # the batch's first post waited for the rest: how far apart
            # the 8 posts reached the queue
            waits = [r["result"]["queued_s"] for r in dyn]
            require(max(sizes) == 8, f"server_entry: dynamic batch sizes "
                                     f"{sizes}, none 8 (queued_s {waits})")
        finally:
            for p in procs.values():
                p.stop()
    emit({"phase": "server_entry", "model": "tiny", "dtype": "bfloat16",
          "quant": "auto", "slots": 8, "max_new": SERVE_MAX_NEW,
          "startup_s": {k: v[2] for k, v in ports.items()},
          "startup_line": ports["continuous"][1],
          **latency(replies, wall, sum(secs)),
          "stats": stats, "burst_codes": codes, "burst_503": n503,
          "burst_wall_s": burst_wall, "dynamic_batch_sizes": sizes,
          "dynamic_wait_ms": DYNAMIC_WAIT_MS,
          "dynamic_arrival_spread_s": max(waits) - min(waits),
          "dynamic_wall_s": dyn_wall,
          "seconds": time.perf_counter() - t_phase, "card": card})


def record_fills(b) -> list:
    """Wraps the engine's slot fill: each fill appends (its prompt
    bucket, the audio of every request it took). Returns that list."""
    fills = []
    real = b._fill_free_slots

    def recorded():
        free = sum(s is None for s in b._slots)
        taken = [req[1] for req in b._queue[:free]]
        before = dict(b.fill_buckets)
        real()
        grown = [p for p, n in b.fill_buckets.items()
                 if n > before.get(p, 0)]
        if grown:
            fills.append((grown[0], taken))

    b._fill_free_slots = recorded
    return fills


def solo_tokens(eng, audio: np.ndarray, p_pad: int) -> list:
    """One request alone on the server's engine (the same slot count), its
    batched prefill in the bucket its crowded fill had: a fill above the
    8 bucket crosses the 16 MiB gate and reads through flash, which rounds
    otherwise than the reference read."""
    b = eng._b
    b._P_BUCKETS = tuple(p for p in type(b)._P_BUCKETS if p >= p_pad)
    try:
        return eng.transcribe(audio).tokens
    finally:
        del b._P_BUCKETS


def server_turbo(card: str, kernels: dict) -> dict:
    """large-v3-turbo at full width and depth, bf16, the serving policy as
    the JAX server applies it (quant="auto", no batch hint): a
    TranscriptionServer over a ContinuousEngine of 8 slots, 16 SSE clients
    at 22.05 kHz, every 4th a 75 s file; every count set to 0 just before
    the clients are released and read after the last reply. Each short
    request's tokens equal its solo run on the engine. Then a
    BatchedTranscriber with max_batch 8 and 8 concurrent 30 s requests
    (one batch), and fault recovery: a poisoned step fails the pending
    request, the next one is served. Returns the launch counts."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.server import (
        ContinuousEngine,
        TranscriptionServer,
        _decode_wav_bytes,
    )
    from whisper_tpu_torch.serving import BatchedTranscriber
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher
    from whisper_tpu_torch.tokenizer import Tokenizer, build_prompt
    t_phase = time.perf_counter()
    tcfg = get_config(TURBO)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = write_v3_vocab(Tokenizer(config=get_config("tiny")).tokens,
                               tmp)
        pipe = WhisperPipeline.from_params(
            card_init_params(tcfg, 0), TURBO, dtype="bfloat16",
            device="cuda", vocab_path=vocab, quant="auto")
    cfg = pipe.cfg
    require(quant_flags(cfg) == ["weight_quant", "cross_kv_quant",
                                 "encoder_mlp_quant", "encoder_qkv_quant"],
            f"turbo serving quant: {quant_flags(cfg)}")
    b = ContinuousBatcher(pipe.params, cfg, max_slots=8,
                          max_new=SERVE_MAX_NEW, tokenizer=pipe.tokenizer)
    eng = ContinuousEngine(b)
    eng.warmup()
    steps = [0]
    step_device = b.step_device

    def counted_step(k: int = 1):
        steps[0] += k
        step_device(k)

    b.step_device = counted_step
    fills = record_fills(b)
    mix = serve_mix(16, seed=80)
    secs = [s for _, s in mix]
    with TranscriptionServer(eng, cfg, host="127.0.0.1", port=0) as srv:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        steps[0] = 0
        replies, wall = run_clients(srv.port, [body for body, _ in mix],
                                    [True] * 16)
        launches = {name: fn.launches for name, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_replies(replies, secs, cfg, SERVE_MAX_NEW, "server_turbo")
        stats = http_json(srv.port, "/v1/stats")
        require(stats["completed"] == 16 and stats["failed"] == 0,
                f"server_turbo: /v1/stats {stats}")
        line = {"phase": "server_turbo", "model": cfg.name,
                "dtype": cfg.compute_dtype, "quant": quant_flags(cfg),
                "slots": b.B, "clients": 16, "max_new": SERVE_MAX_NEW,
                **latency(replies, wall, sum(secs)),
                "queue_stats": stats["queue"], "peak_mem_gb": peak,
                "launches": launches, "fills": len(fills),
                "fill_buckets": dict(b.fill_buckets),
                "engine_steps": steps[0], "detect_language_calls": 0,
                "card": card}
        counts = check_engine_launches(line, b, cfg, 0)
        require(counts["encoder_block_tail_q8"]
                == tcfg.n_audio_layers * len(fills) > 0,
                "server_turbo: not one int8 tail launch a layer a fill")
        # each short request against its solo run
        solo_same = []
        for i, (body, s) in enumerate(mix):
            if s != SERVE_SHORT_S:
                continue
            audio = _decode_wav_bytes(body, cfg.sample_rate)
            p_pad = [p for p, taken in fills
                     if any(len(a) == len(audio) and np.array_equal(a, audio)
                            for a in taken)]
            require(len(p_pad) == 1, f"server_turbo: client {i} was in "
                                     f"{len(p_pad)} fills")
            solo = solo_tokens(eng, audio, p_pad[0])
            solo_same.append(solo == replies[i]["result"]["tokens"])
        emit({"phase": "server_turbo_solo", "identical": solo_same,
              "fill_buckets_of_fills": [p for p, _ in fills], "card": card})
        require(all(solo_same), "server_turbo: a short request's tokens "
                                "differ from its solo run")
        # fault recovery on the card
        clip = _decode_wav_bytes(mix[0][0], cfg.sample_rate)
        want = solo_tokens(eng, clip, 8)

        def poisoned(k: int = 1):
            raise RuntimeError("poisoned step")

        b.step_device = poisoned
        try:
            eng.transcribe(clip)
            raised = False
        except RuntimeError as e:
            raised = "poisoned" in str(e)
        recovered = (all(s is None for s in b._slots) and not eng._pending
                     and not b._queue)
        b.step_device = step_device
        again = eng.transcribe(clip).tokens
        emit({"phase": "server_turbo_fault", "raised": raised,
              "slots_reset": recovered, "next_equal_solo": again == want,
              "card": card})
        require(raised and recovered and again == want,
                "server_turbo: no recovery from a poisoned step")
    del eng, b
    gc.collect()
    # the dynamic batcher: 8 concurrent 30 s requests, one batch
    bt = BatchedTranscriber(pipe.params, cfg, pipe.tokenizer, max_batch=8,
                            max_wait_ms=1000, max_new=SERVE_MAX_NEW)
    batches = [0]
    transcribe_batch = bt._transcribe_batch

    def counted_batch(audio, prompts):
        batches[0] += 1
        return transcribe_batch(audio, prompts)

    bt._transcribe_batch = counted_batch
    try:
        clips = bench_audio(cfg, 8)
        bt.transcribe(clips[0])                      # warm-up, one row
        batches[0] = 0
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = [f.result() for f in [bt.submit(c) for c in clips]]
        bwall = time.perf_counter() - t0
        blaunch = {name: fn.launches for name, fn in kernels.items()}
    finally:
        bt.close()
    prompt = build_prompt(cfg)
    bline = {"phase": "server_turbo_batcher", "max_batch": 8,
             "batches": batches[0], "batch_sizes": [r.batch_size for r in res],
             "wall_s": bwall, "audio_rtfx": 8 * cfg.chunk_length_s / bwall,
             "launches": blaunch, "card": card}
    emit(bline)
    require(batches[0] == 1 and all(r.batch_size == 8 for r in res),
            "server_turbo_batcher: not one batch of 8")
    require(all(r.tokens[:len(prompt)] == prompt
                and len(r.tokens) == len(prompt) + 1 + SERVE_MAX_NEW
                for r in res), "server_turbo_batcher: not every row ran to "
                               "its cap after the SOT prompt")
    # the bf16 greedy batch of 8: one int8 tail launch a layer, one append
    # a loop step; the 4-token prefill's B=8 reads stay under the gate
    for name, want in {"encoder_block_tail_q8": tcfg.n_audio_layers,
                       "cache_append_rows": SERVE_MAX_NEW,
                       "encoder_block_tail": 0, "flash_attention": 0,
                       "cache_append_rows_ragged": 0, **NO_DECODE,
                       "decode_attention_q8_bh": 0,
                       "fused_decoder_step": 0}.items():
        require(blaunch[name] == want, f"server_turbo_batcher: {name} "
                                       f"launches {blaunch[name]} != {want}")
    del pipe, bt
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "server_turbo_seconds",
          "seconds": time.perf_counter() - t_phase, "card": card})
    return {"engine": counts, "batcher": blaunch}


def server_fp32_parity(card: str, kernels: dict) -> dict:
    """Tiny fp32 (token-parity mode) through both servers in turn, on the
    card and then on the CPU (device="cpu"): the served tokens of 4
    requests (5, 10 and 20 s, and a 75 s file) equal bit for bit. Returns
    the card's launches, by engine."""
    from whisper_tpu_torch import get_config, weights
    from whisper_tpu_torch.server import ContinuousEngine, TranscriptionServer
    from whisper_tpu_torch.serving import BatchedTranscriber
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher
    t_phase = time.perf_counter()
    cfg = get_config("tiny")
    params = weights.init_params(cfg, seed=0)
    secs = (5.0, 10.0, 20.0, SERVE_LONG_S)
    bodies = [wav_bytes(longform_clip(s, SERVE_RATE, 90 + i), SERVE_RATE)
              for i, s in enumerate(secs)]

    def make(engine: str, device: str):
        if engine == "dynamic":
            return BatchedTranscriber(params, cfg, max_batch=4,
                                      max_new=SERVE_MAX_NEW, device=device)
        return ContinuousEngine(ContinuousBatcher(
            params, cfg, max_slots=4, max_new=SERVE_MAX_NEW, device=device))

    served, launches = {}, {}
    for engine in ("dynamic", "continuous"):
        for device in ("cuda", "cpu"):
            for fn in kernels.values():
                fn.launches = 0
            with TranscriptionServer(make(engine, device), cfg,
                                     host="127.0.0.1", port=0) as srv:
                replies, _ = run_clients(srv.port, bodies, [False] * 4)
            check_replies(replies, list(secs), cfg, SERVE_MAX_NEW,
                          f"server_fp32_parity {engine} {device}")
            served[engine, device] = [r["result"]["tokens"] for r in replies]
            if device == "cuda":
                launches[engine] = {n: fn.launches
                                    for n, fn in kernels.items()}
    same = {e: served[e, "cuda"] == served[e, "cpu"]
            for e in ("dynamic", "continuous")}
    emit({"phase": "server_fp32_parity", "requests_s": list(secs),
          "identical": same,
          "tokens": [len(t) for t in served["continuous", "cuda"]],
          "launches": launches, "seconds": time.perf_counter() - t_phase,
          "card": card})
    require(all(same.values()), f"server_fp32_parity: card tokens differ "
                                f"from the CPU's: {same}")
    require(launches["dynamic"]["encoder_block_tail"] > 0
            and launches["continuous"]["cache_append_rows_ragged"] > 0,
            "server_fp32_parity: the card's servers launched no kernel")
    return launches


def serving_counts(serving: dict, name: str) -> dict:
    """One kernel's launches in each serving phase that counts them."""
    return {"turbo_engine": serving["turbo"]["engine"][name],
            "turbo_batcher": serving["turbo"]["batcher"][name],
            "fp32_dynamic": serving["fp32"]["dynamic"][name],
            "fp32_continuous": serving["fp32"]["continuous"][name]}


def serving_group(card: str) -> dict:
    """The serving layer's phases (--only serving): server_entry,
    server_turbo, server_fp32_parity. Returns their launch counts."""
    kernels = kernel_wrappers()
    t0 = time.perf_counter()
    server_entry(card)
    turbo = server_turbo(card, kernels)
    fp32 = server_fp32_parity(card, kernels)
    emit({"phase": "serving_group", "seconds": time.perf_counter() - t0,
          "card": card})
    return {"turbo": turbo, "fp32": fp32}


def train_batch(cfg, B: int, seed: int, device: str = "cuda"):
    """A fixed teacher-forcing batch: the log-mel of the bench's clips,
    the 4-token prompt and 220 seeded text tokens below EOT, the loss on
    every text token (mask 1 from the prompt's last position)."""
    import torch

    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.tokenizer import build_prompt
    from whisper_tpu_torch.train import TrainBatch
    prompt = build_prompt(cfg)
    P = len(prompt)
    rng = np.random.RandomState(seed)
    text = rng.randint(0, cfg.eot_token, (B, TRAIN_T - P))
    tokens = np.concatenate([np.tile(prompt, (B, 1)), text], axis=1)
    mask = np.ones((B, TRAIN_T), np.float32)
    mask[:, :P - 1] = 0.0
    mel = log_mel_spectrogram(torch.from_numpy(bench_audio(cfg, B)).cuda(),
                              cfg)
    return TrainBatch(mel.to(device), torch.from_numpy(tokens).to(device),
                      torch.from_numpy(mask).to(device))


def grad_leaves(params) -> dict:
    """The gradients of a trainable tree in the JAX package's layout (the
    fused qkv split again), on the CPU, by JAX key path."""
    from whisper_tpu_torch.weights import _keystr_leaves, _tree_map, from_device
    return dict(_keystr_leaves(from_device(_tree_map(lambda p: p.grad,
                                                     params))))


def check_grads(grads: dict, label: str) -> float:
    """Every gradient finite; every leaf's non-zero but the key biases',
    which must be noise (below KEY_BIAS_SHARE of the largest |g|): a
    kernel output with no graph would leave the leaves below it at zero.
    Returns the largest |g|."""
    import torch
    top = max(float(g.abs().max()) for g in grads.values())
    for key, g in grads.items():
        require(bool(torch.isfinite(g).all()),
                f"{label}: non-finite grad {key}")
        m = float(g.abs().max())
        if key in KEY_BIASES:
            require(m <= KEY_BIAS_SHARE * top,
                    f"{label}: key-bias grad {key} {m} of {top}")
        else:
            require(m > 0, f"{label}: zero gradient at {key}")
    return top


def counted(kernels: dict) -> dict:
    """The kernels launched since their counts were set to 0."""
    return {name: fn.launches for name, fn in kernels.items() if fn.launches}


def zero_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def train_steps(params, opt, cfg, batch, steps: int, kernels: dict,
                expect: dict, label: str) -> dict:
    """`steps` train_step calls, each with the launch counts set to 0 just
    before it and read just after it (each must equal `expect`: the
    forward's, since the backward launches none); the losses, pre-clip
    norms and host walls."""
    import torch

    from whisper_tpu_torch.train import train_step
    out = {"losses": [], "grad_norms": [], "step_s": []}
    for i in range(steps):
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(params, opt, cfg, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        launches = counted(kernels)
        require(launches == expect,
                f"{label} step {i}: launches {launches} != {expect}")
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        require(np.isfinite(out["losses"][-1])
                and np.isfinite(out["grad_norms"][-1]),
                f"{label} step {i}: loss {out['losses'][-1]}, norm "
                f"{out['grad_norms'][-1]}")
    out["launches_per_step"] = launches   # the last step's, as counted
    return out


def forward_backward(params, cfg, batch, kernels: dict) -> dict:
    """One loss_fn and one backward, each timed on the host around work
    that ends in a synchronize and each with its own launch counts; the
    parameters are left as they were (the gradients stay in .grad)."""
    import torch

    from whisper_tpu_torch.models.whisper import full_fp32, tree_leaves
    from whisper_tpu_torch.train import loss_fn
    for p in tree_leaves(params):
        p.grad = None
    with full_fp32():
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = counted(kernels)
        zero_counts(kernels)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return {"loss": loss.item(), "forward_s": t1 - t0,
            "backward_s": t2 - t1, "forward_launches": fwd,
            "backward_launches": counted(kernels)}


def train_expect(cfg, B: int) -> dict:
    """The launches of one training forward: the tail once per encoder
    layer, and flash for each decoder read the 16 MiB gate sends to it
    (the causal self read over the 448 slots of JAX's cache, the cross
    read over 1500 positions)."""
    n_flash = cfg.n_text_layers * sum(
        routed(cfg, B, TRAIN_T, S, "flash")
        for S in (cfg.n_text_ctx, cfg.n_audio_ctx))
    return {"encoder_block_tail": cfg.n_audio_layers,
            **({"flash_attention": n_flash} if n_flash else {})}


def train_tiny(card: str, kernels: dict) -> dict:
    """Tiny at full width and depth in fp32: 6 train_step calls on one
    fixed batch of 16 (lr 1e-3, warmup 1, total 50), weights drawn on the
    card. The loss falls below 0.95 of the first; then one forward and
    backward apart (the backward launches no kernel; every gradient
    finite, every leaf's non-zero but the key biases')."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.train import make_optimizer
    from whisper_tpu_torch.weights import trainable
    cfg = get_config("tiny")
    params = trainable(card_init_params(cfg, 0), "cuda")
    opt = make_optimizer(params, lr=1e-3, warmup_steps=1, total_steps=50)
    batch = train_batch(cfg, TRAIN_TINY_BATCH, seed=0)
    expect = train_expect(cfg, TRAIN_TINY_BATCH)
    require(expect == {"encoder_block_tail": 4, "flash_attention": 8},
            f"train_tiny: the gate gives {expect}")
    torch.cuda.reset_peak_memory_stats()
    run = train_steps(params, opt, cfg, batch, TRAIN_TINY_STEPS, kernels,
                      expect, "train_tiny")
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = forward_backward(params, cfg, batch, kernels)
    top = check_grads(grad_leaves(params), "train_tiny")
    line = {"phase": "train_tiny", "model": cfg.name, "dtype": "float32",
            "batch": TRAIN_TINY_BATCH, "tokens": TRAIN_T, **run,
            "median_step_s": float(np.median(run["step_s"][1:])),
            "peak_mem_gb": peak, **split,
            "backward_share": split["backward_s"]
            / (split["forward_s"] + split["backward_s"]),
            "max_abs_grad": top, "card": card}
    emit(line)
    require(run["losses"][-1] < 0.95 * run["losses"][0],
            f"train_tiny: loss {run['losses'][0]} -> {run['losses'][-1]}")
    require(split["forward_launches"] == expect,
            f"train_tiny: forward launches {split['forward_launches']}")
    require(split["backward_launches"] == {},
            f"train_tiny: the backward launched {split['backward_launches']}")
    del params, opt
    torch.cuda.empty_cache()
    return run["launches_per_step"]


def train_grad_parity(card: str, kernels: dict) -> None:
    """One step's gradients of tiny (B=8: both decoder reads through
    flash) on the card against the port on the CPU, from the same weights
    and batch: the loss to 1e-5 of itself, every leaf to TRAIN_GRAD_RTOL
    of its largest |g|, the key biases as noise on both."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.models.whisper import full_fp32
    from whisper_tpu_torch.train import TrainBatch, loss_fn
    from whisper_tpu_torch.weights import _tree_map, trainable
    cfg = get_config("tiny")
    tree = card_init_params(cfg, 1)
    batch = train_batch(cfg, TRAIN_PARITY_BATCH, seed=1)
    expect = train_expect(cfg, TRAIN_PARITY_BATCH)
    out, seen = {}, None
    for dev in ("cuda", "cpu"):
        params = trainable(_tree_map(lambda t: t.to(dev), tree), dev)
        b = TrainBatch(*(t.to(dev) for t in batch))
        zero_counts(kernels)
        t0 = time.perf_counter()
        with full_fp32():
            loss = loss_fn(params, cfg, b)
            loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            seen = counted(kernels)
            require(seen == expect, f"train_grad_parity: launches {seen}")
        out[dev] = (loss.item(), grad_leaves(params),
                    time.perf_counter() - t0)
        del params
    (lc, g_card, sc), (lh, g_host, sh) = out["cuda"], out["cpu"]
    check_grads(g_card, "train_grad_parity cuda")
    check_grads(g_host, "train_grad_parity cpu")
    worst, worst_key = 0.0, None
    for key, want in g_host.items():
        if key in KEY_BIASES:
            continue
        err = float((g_card[key] - want).abs().max())
        share = err / float(want.abs().max())
        if share > worst:
            worst, worst_key = share, key
    emit({"phase": "train_grad_parity", "model": cfg.name,
          "batch": TRAIN_PARITY_BATCH, "tokens": TRAIN_T, "loss_cuda": lc,
          "loss_cpu": lh, "worst_leaf_err_share": worst,
          "worst_leaf": worst_key, "launches": seen, "cuda_s": sc,
          "cpu_s": sh, "card": card})
    require(abs(lc - lh) <= 1e-5 * abs(lh), f"train loss {lc} vs CPU {lh}")
    require(worst <= TRAIN_GRAD_RTOL,
            f"train_grad_parity: {worst_key} off by {worst} of its max")
    torch.cuda.empty_cache()


def train_turbo(card: str, kernels: dict) -> dict:
    """large-v3-turbo at full width and depth in fp32: 2 train_step calls
    on a batch of 4 (weights drawn on the card; lr 1e-4 with no warmup, so
    the first update moves the weights): finite losses, a second loss
    unlike the first, 32 tail and 8 flash launches a step, every gradient
    finite and every leaf's non-zero but the key biases', the peak memory
    and the step walls."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.models.whisper import tree_leaves
    from whisper_tpu_torch.train import make_optimizer
    from whisper_tpu_torch.weights import trainable
    cfg = get_config(TURBO)
    params = trainable(card_init_params(cfg, 0), "cuda")
    opt = make_optimizer(params, lr=1e-4, warmup_steps=0, total_steps=50)
    batch = train_batch(cfg, TRAIN_TURBO_BATCH, seed=2)
    expect = train_expect(cfg, TRAIN_TURBO_BATCH)
    require(expect == {"encoder_block_tail": 32, "flash_attention": 8},
            f"train_turbo: the gate gives {expect}")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    run = train_steps(params, opt, cfg, batch, TRAIN_TURBO_STEPS, kernels,
                      expect, "train_turbo")
    peak = torch.cuda.max_memory_allocated() / 1e9
    top = check_grads(grad_leaves(params), "train_turbo")
    emit({"phase": "train_turbo", "model": cfg.name, "dtype": "float32",
          "batch": TRAIN_TURBO_BATCH, "tokens": TRAIN_T, **run,
          "peak_mem_gb": peak, "resident_gb_before": resident,
          "n_params": sum(p.numel() for p in tree_leaves(params)),
          "max_abs_grad": top, "card": card})
    require(run["losses"][-1] != run["losses"][0],
            f"train_turbo: the update left the loss at {run['losses'][0]}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches_per_step"]


def train_kernel_time(card: str) -> dict:
    """The train path's two kernels at tiny's training shapes (B=16, fp32):
    each forward (the kernel) and backward (the plain twin's autograd),
    timed by CUDA events beside the forward's bound, the plain forward and,
    for flash, SDPA's forward and backward on the same inputs (SDPA is
    timed here only; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_plain,
    )
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    cfg = get_config("tiny")
    B, H, D = TRAIN_TINY_BATCH, cfg.n_heads, cfg.head_dim
    g = torch.Generator(device="cpu").manual_seed(5)
    lines = {}

    def timed(name, kernel, plain, args, flops, sdpa=None, read=None):
        args = [a.requires_grad_() for a in args]
        grad_out = torch.randn(kernel(*args).shape, generator=g).cuda()
        # each input read once, at the extent the function reads (`read`
        # elements; all of every input unless given), the output written
        # once
        full = sum(a.numel() for a in args)
        read = full if read is None else read
        moved = 4 * (read + grad_out.numel())
        with torch.no_grad():
            fwd, plain_ms = alternate_ms(lambda: plain(*args),
                                         lambda: kernel(*args), iters=10)
        out = kernel(*args)
        bwd = cuda_ms(lambda: torch.autograd.grad(out, args, grad_out,
                                                  retain_graph=True), 5)
        line = {"ms": fwd, "plain_ms": plain_ms, "backward_ms": bwd,
                **bound(moved, flops, "float32"),
                # the backward's five products (q.k, p.v, and dv, dp, dq
                # and dk: 2.5 times the forward's), its inputs (at their
                # read extent) and the output gradient read, the input
                # gradients written whole
                "backward_bound_ms": bound(moved + 4 * full, 2.5 * flops,
                                           "float32")["bound_ms"]}
        if sdpa is not None:
            with torch.no_grad():
                line["library_ms"] = cuda_ms(lambda: sdpa(*args), 10)
            lout = sdpa(*args)
            line["library_backward_ms"] = cuda_ms(
                lambda: torch.autograd.grad(lout, args, grad_out,
                                            retain_graph=True), 5)
        else:
            line["library_ms"] = None
        lines[name] = line
        emit({"phase": "train_kernel_time", "kernel": name, "batch": B,
              "dtype": "float32", **line, "card": card})

    def r(*shape):
        return torch.randn(*shape, generator=g).cuda()

    def sdpa_of(kv_len, causal):
        def f(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :, :kv_len], v[:, :, :kv_len],
                is_causal=causal).transpose(1, 2)
        return f

    T, S = TRAIN_T, cfg.n_text_ctx
    for name, s_len, kv_len, causal in (
            ("flash_self", S, T, True),
            ("flash_cross", cfg.n_audio_ctx, cfg.n_audio_ctx, False)):
        # causal: the kernel reads T (T + 1) / 2 key rows, 4 flops a
        # query-key-dim product pair (q.k and p.v); k and v are read
        # only below kv_len
        pairs = T * (T + 1) // 2 if causal else T * kv_len
        timed(name,
              functools.partial(flash_attention, kv_len=kv_len,
                                causal=causal),
              functools.partial(flash_attention_plain, kv_len=kv_len,
                                causal=causal),
              [r(B, T, H, D), r(B, H, s_len, D), r(B, H, s_len, D)],
              4 * B * H * pairs * D, sdpa_of(kv_len, causal),
              read=B * T * H * D + 2 * B * H * min(s_len, kv_len) * D)
    tail = tail_inputs(cfg, B, torch.float32, seed=6)
    Ta, d, ff = cfg.n_audio_ctx, cfg.d_model, cfg.d_ff
    timed("encoder_block_tail", encoder_block_tail,
          encoder_block_tail_plain, tail,
          4 * B * H * Ta * Ta * D + 2 * B * Ta * (d * d + 2 * d * ff))
    torch.cuda.empty_cache()
    return lines


def train_group(card: str) -> dict:
    """The train phases (--only train): train_tiny, train_grad_parity,
    train_turbo and the two kernels' forward and backward times. Returns
    the launches a step of tiny and of turbo."""
    kernels = kernel_wrappers()
    t0 = time.perf_counter()
    tiny = train_tiny(card, kernels)
    train_grad_parity(card, kernels)
    turbo = train_turbo(card, kernels)
    times = train_kernel_time(card)
    emit({"phase": "train_group", "seconds": time.perf_counter() - t0,
          "card": card})
    return {"tiny": tiny, "turbo": turbo, "times": times}


def mesh_eot_options(cfg):
    """EOT banned at every step: the decode does fixed work, the same on
    every path compared."""
    from whisper_tpu_torch.decode_rules import DecodeOptions
    return DecodeOptions(suppress_tokens=(cfg.eot_token,))


def mesh_counts(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def mesh_line(check: str, mesh: str, backend: str, world: int, card: str,
              **fields) -> dict:
    line = {"phase": "mesh", "check": check, "mesh": mesh,
            "backend": backend, "world_size": world, **fields,
            "card": card}
    if backend == "gloo":
        line["note"] = MESH_NOTE
    emit(line)
    return line


def mesh_nccl(card: str, vocab: str) -> dict:
    """(a) A world of one NCCL process that make_mesh opens itself: turbo
    bf16 at full width and depth through ShardedPipeline(dp=1, tp=1), B=8,
    32 greedy tokens with EOT banned; its tokens equal WhisperPipeline's
    in this process; one tail launch a layer, one append a step."""
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.parallel.inference import ShardedPipeline
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.tokenizer import Tokenizer
    kernels = kernel_wrappers()
    cfg = get_config(TURBO).replace(compute_dtype="bfloat16")
    params = card_init_params(cfg, 0)
    pipe = WhisperPipeline.from_params(params, cfg, dtype="bfloat16",
                                       device="cuda", vocab_path=vocab,
                                       quant="off")
    audio = bench_audio(cfg, MESH_BATCH)
    opts = mesh_eot_options(cfg)
    max_new = MESH_NCCL_TOKENS - 1
    res = pipe.transcribe_batch(audio, max_new=max_new, opts=opts)
    want = [res.tokens[b, :res.lengths[b]].tolist()
            for b in range(MESH_BATCH)]
    del pipe, res
    require(not dist.is_initialized(), "mesh: a process group exists")
    spipe = ShardedPipeline(params, cfg, dp=1, tp=1, device="cuda",
                            tokenizer=Tokenizer(vocab, config=cfg))
    del params
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "mesh: make_mesh did not open a world of one NCCL process")
    spipe.transcribe_batch(audio, max_new=max_new, opts=opts)   # warm-up
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = spipe.transcribe_batch(audio, max_new=max_new, opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mesh_counts(kernels)
    dist.destroy_process_group()
    del spipe
    torch.cuda.empty_cache()
    equal = [row["tokens"] for row in got] == want
    line = mesh_line("nccl_world_of_one", "dp1_sp1_tp1", "nccl", 1, card,
                     model=cfg.name, dtype="bfloat16", batch=MESH_BATCH,
                     gen_tokens=MESH_NCCL_TOKENS, wall_s=wall,
                     tokens_equal_one_card=equal,
                     launches_by_rank=[launches])
    require(equal, "mesh: ShardedPipeline tokens differ from "
                   "WhisperPipeline's")
    require(launches["encoder_block_tail"] == cfg.n_audio_layers,
            f"mesh nccl: {launches['encoder_block_tail']} tail launches")
    require(launches["cache_append_rows"] == max_new,
            f"mesh nccl: {launches['cache_append_rows']} appends")
    require(all(len(row["tokens"]) == 4 + MESH_NCCL_TOKENS for row in got),
            "mesh nccl: token count")
    return line


def mesh_turbo_reference(audio: np.ndarray, vocab: str) -> dict:
    """The one-card fp32 run that the gloo ranks are held to: turbo with
    tok_emb x 4 (drawn on the card from seed 1), the prefill logits and
    the greedy tokens of the B=8 batch, and the pipelined forwards' input
    mel."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.audio import log_mel_spectrogram
    from whisper_tpu_torch.decode import encode
    from whisper_tpu_torch.models.whisper import (
        decoder_forward,
        full_fp32,
        init_kv_cache,
        precompute_cross_kv,
    )
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.tokenizer import build_prompt
    cfg = get_config(TURBO)
    params = mesh_decisive(card_init_params(cfg, 1))
    pipe = WhisperPipeline.from_params(params, cfg, dtype="float32",
                                       device="cuda", vocab_path=vocab,
                                       quant="off")
    del params
    res = pipe.transcribe_batch(audio, max_new=MESH_GLOO_TOKENS - 1,
                                opts=mesh_eot_options(cfg))
    tokens = [res.tokens[b, :res.lengths[b]].tolist()
              for b in range(MESH_BATCH)]
    prompt = torch.tensor([build_prompt(cfg)] * MESH_BATCH, device="cuda")
    with torch.inference_mode(), full_fp32():
        mel = log_mel_spectrogram(torch.from_numpy(audio).cuda(), cfg)
        enc = encode(pipe.params, cfg, mel)
        cross = precompute_cross_kv(pipe.params, cfg, enc)
        cache = init_kv_cache(cfg, MESH_BATCH, torch.float32, 64, "cuda")
        logits, _ = decoder_forward(pipe.params, cfg, prompt, 0, cache,
                                    cross)
    return {"pipe": pipe, "tokens": tokens, "logits": logits.cpu(),
            "enc": enc, "mel": mel.cpu().numpy(),
            "prompt": prompt.cpu().numpy()}


def mesh_decisive(params: dict) -> dict:
    params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"] * 4.0
    return params


def mesh_close(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, whether every value is within atol + rtol|want|)."""
    import torch
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    err = (got - want).abs()
    return float(err.max()), bool((err <= tol[0] + tol[1]
                                   * want.abs()).all())


def mesh_group(card: str) -> dict:
    """The mesh phase (--only mesh): (a) in this process, (b) in four gloo
    processes (mesh_rank), each check held to this process's one-card
    runs. Returns each check's launches by rank, for the kernels line."""
    import torch

    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.models.whisper import decoder_forward, full_fp32
    from whisper_tpu_torch.models.whisper import init_kv_cache
    from whisper_tpu_torch.models.whisper import precompute_cross_kv
    from whisper_tpu_torch.parallel import launch
    from whisper_tpu_torch.tokenizer import Tokenizer
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        vocab = write_v3_vocab(Tokenizer(config=get_config("tiny")).tokens,
                               tmp)
        line = mesh_nccl(card, vocab)
        out["nccl_world_of_one"] = line["launches_by_rank"]
        audio = bench_audio(get_config(TURBO), MESH_BATCH)
        ref = mesh_turbo_reference(audio, vocab)
        rng = np.random.RandomState(4)
        cfg = get_config(TURBO)
        pp_tokens = rng.randint(0, cfg.eot_token, (MESH_BATCH, MESH_PP_T))
        t0 = time.perf_counter()
        ranks = launch.run(
            "chip_smoke:mesh_rank", MESH_WORLD,
            (vocab, audio, ref["mel"], ref["prompt"], pp_tokens, tmp),
            timeout=MESH_TIMEOUT_S, threads=2)
        world_s = time.perf_counter() - t0
        pipe = ref["pipe"]
        # ShardedPipeline at every MESH_GLOO mesh
        for dp, tp, sp in MESH_GLOO:
            key = f"dp{dp}_sp{sp}_tp{tp}"
            rows = [r["pipelines"][key] for r in ranks]
            logits = torch.cat([torch.from_numpy(r["logits"])
                                for r in rows if r["logits"] is not None])
            err, ok = mesh_close(logits, ref["logits"], MESH_LOGITS_TOL)
            equal = all(r["tokens"] == ref["tokens"] for r in rows)
            launches = [r["launches"] for r in rows]
            out[key] = launches
            mesh_line("sharded_pipeline", key, "gloo", MESH_WORLD, card,
                      model=cfg.name, dtype="float32", batch=MESH_BATCH,
                      gen_tokens=MESH_GLOO_TOKENS,
                      wall_s_by_rank=[r["wall_s"] for r in rows],
                      prefill_logits_max_abs_err=err,
                      tolerance=MESH_LOGITS_TOL,
                      tokens_equal_one_card=equal,
                      launches_by_rank=launches,
                      transports_by_rank=[r["transports"] for r in rows])
            require(ok, f"mesh {key}: prefill logits off by {err}")
            require(equal, f"mesh {key}: tokens differ from the one card's")
            steps = MESH_GLOO_TOKENS - 1
            for r in launches:
                require(r["cache_append_rows"] == steps,
                        f"mesh {key}: {r['cache_append_rows']} appends")
                if tp > 1:
                    require(r["flash_attention"] == cfg.n_audio_layers
                            and r["encoder_block_tail"] == 0,
                            f"mesh {key}: flash {r['flash_attention']}, "
                            f"tail {r['encoder_block_tail']}")
                else:
                    require(r["encoder_block_tail"] == cfg.n_audio_layers,
                            f"mesh {key}: tail {r['encoder_block_tail']}")
        # the pipelined forwards at pp = 4
        pp = ranks[0]["pp"]
        enc_err, enc_ok = mesh_close(pp["enc"], ref["enc"].cpu(),
                                     MESH_ENC_TOL)
        with torch.inference_mode(), full_fp32():
            enc_pp = torch.from_numpy(pp["enc"]).cuda()
            cross = precompute_cross_kv(pipe.params, cfg, enc_pp)
            cache = init_kv_cache(cfg, MESH_BATCH, torch.float32, 64, "cuda")
            want, _ = decoder_forward(pipe.params, cfg,
                                      torch.from_numpy(pp_tokens).cuda(), 0,
                                      cache, cross)
        dec_err, dec_ok = mesh_close(pp["dec"], want.cpu(), MESH_LOGITS_TOL)
        out["pp4_forward"] = [r["pp"]["launches"] for r in ranks]
        mesh_line("pipelined_forwards", "pp4", "gloo", MESH_WORLD, card,
                  model=cfg.name, dtype="float32", batch=MESH_BATCH,
                  microbatches=4, encoder_max_abs_err=enc_err,
                  encoder_tolerance=MESH_ENC_TOL,
                  decoder_logits_max_abs_err=dec_err,
                  decoder_tolerance=MESH_LOGITS_TOL,
                  wall_s_by_rank=[r["pp"]["wall_s"] for r in ranks],
                  launches_by_rank=out["pp4_forward"],
                  transports_by_rank=[r["pp"]["transports"] for r in ranks])
        require(enc_ok, f"mesh pp4: encoder off by {enc_err}")
        require(dec_ok, f"mesh pp4: decoder logits off by {dec_err}")
        for r in ranks:
            require(r["pp"]["launches"]["flash_attention"]
                    == cfg.n_audio_layers,
                    f"mesh pp4: {r['pp']['launches']['flash_attention']} "
                    f"flash launches on a rank")
        del ref, pipe, enc_pp, cross, cache, want
        torch.cuda.empty_cache()
        # tiny's train steps, the MoE, the checkpoint: checked in the ranks
        for name in ("train_pp4", "train_dp2_tp2"):
            rows = [r[name] for r in ranks]
            out[name] = [r["launches"] for r in rows]
            mesh_line(name, name[6:], "gloo", MESH_WORLD, card,
                      model="tiny", dtype="float32",
                      loss=rows[0]["loss"], one_card_loss=rows[0]["ref_loss"],
                      grad_max_abs_err=max(r["grad_err"] for r in rows),
                      one_card_grad_max=rows[0]["ref_grad_max"],
                      tolerance=MESH_GRAD_SHARE,
                      wall_s_by_rank=[r["wall_s"] for r in rows],
                      launches_by_rank=out[name],
                      transports_by_rank=[r["transports"] for r in rows])
        out["moe_ep4"] = [r["moe"]["launches"] for r in ranks]
        mesh_line("moe_mlp_sharded", "dp1_ep4", "gloo", MESH_WORLD, card,
                  shape=MESH_MOE,
                  max_abs_err=max(r["moe"]["err"] for r in ranks),
                  tolerance=MESH_MOE_ATOL,
                  wall_s_by_rank=[r["moe"]["wall_s"] for r in ranks],
                  launches_by_rank=out["moe_ep4"])
        mesh_line("dcp_checkpoint", "tp4_to_tp2_and_unsharded", "gloo",
                  MESH_WORLD, card, model="tiny",
                  bit_equal_tp2=all(r["dcp"]["tp2"] for r in ranks),
                  bit_equal_unsharded=ranks[0]["dcp"]["whole"],
                  wall_s_by_rank=[r["dcp"]["wall_s"] for r in ranks])
        mesh_line("gloo_cuda_probe", "world", "gloo", MESH_WORLD, card,
                  probe=ranks[0]["probe"], world_s=world_s)
    emit({"phase": "mesh_group", "seconds": time.perf_counter() - t_phase,
          "card": card})
    return out


def mesh_max_err(got: dict, want: dict) -> float:
    """The largest |got - want| over two params trees, leaf by path (inf
    when their paths or shapes differ)."""
    from whisper_tpu_torch.weights import _keystr_leaves
    got, want = dict(_keystr_leaves(got)), dict(_keystr_leaves(want))
    if got.keys() != want.keys() or any(
            got[k].shape != want[k].shape for k in want):
        return float("inf")
    return max(float((got[k].cpu().float() - want[k].cpu().float()).abs()
                     .max()) for k in want)


def mesh_probe() -> dict:
    """Which collectives gloo runs on CUDA tensors on this card's torch:
    each tried once on the world group, "ok" or the error's first line.
    Point-to-point is not tried: gloo's send and recv pass the tensor's
    pointer to its host transport (the helpers copy to the host)."""
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch.ops.collectives import GLOO_CUDA_OPS
    x = torch.ones(8, device="cuda")
    trials = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(dist.get_world_size())], x),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:200]
        dist.barrier()
    for name in GLOO_CUDA_OPS:
        require(out.get(name) == "ok",
                f"mesh: gloo refuses {name} on CUDA tensors: {out.get(name)}")
    return out


def _mesh_timed(kernels: dict, fn):
    """fn() with every count and transport counter at 0 just before it and
    read just after it: (result, wall s, launches, transports)."""
    import torch

    from whisper_tpu_torch.ops import collectives
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    collectives.TRANSPORTS.clear()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, mesh_counts(kernels),
            {f"{op}:{how}": n for (op, how), n in
             sorted(collectives.TRANSPORTS.items())})


def mesh_rank(vocab: str, audio, mel, prompt, pp_tokens, tmp: str) -> dict:
    """One of the four gloo ranks sharing the card (launch.run): the
    transport probe, then each (b) check; returns what mesh_group holds
    to the one-card runs."""
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch import get_config, train, weights
    from whisper_tpu_torch.models.whisper import (
        decoder_forward,
        encoder_forward,
        init_kv_cache,
        precompute_cross_kv,
        tree_leaves,
    )
    from whisper_tpu_torch.parallel import expert
    from whisper_tpu_torch.parallel import pipeline_parallel as ppl
    from whisper_tpu_torch.parallel.inference import ShardedPipeline
    from whisper_tpu_torch.parallel.mesh import (
        axes_mesh,
        make_mesh,
        shard_params,
        shard_tensor,
    )
    from whisper_tpu_torch.tokenizer import Tokenizer
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_wrappers()
    out = {"probe": mesh_probe(), "pipelines": {}}
    cfg = get_config(TURBO)
    tok = Tokenizer(vocab, config=cfg)
    full = mesh_decisive(card_init_params(cfg, 1))
    opts = mesh_eot_options(cfg)
    for dp, tp, sp in MESH_GLOO:
        pipe = ShardedPipeline(full, cfg, dp=dp, tp=tp, sp=sp,
                               device="cuda", tokenizer=tok)
        with torch.inference_mode(), pipe.sharding():
            m = pipe.rows(mel)
            enc = encoder_forward(pipe.params, cfg, m)
            cross = precompute_cross_kv(pipe.params, cfg, enc)
            cache = init_kv_cache(cfg, m.shape[0], torch.float32, 64, "cuda")
            logits, _ = decoder_forward(pipe.params, cfg, pipe.rows(prompt),
                                        0, cache, cross)
        first = (pipe.mesh.get_local_rank("sp") == 0
                 and pipe.mesh.get_local_rank("tp") == 0)
        del enc, cross, cache
        got, wall, launches, transports = _mesh_timed(
            kernels, lambda: pipe.transcribe_batch(
                audio, max_new=MESH_GLOO_TOKENS - 1, opts=opts))
        out["pipelines"][f"dp{dp}_sp{sp}_tp{tp}"] = {
            "logits": logits.cpu().numpy() if first else None,
            "tokens": [row["tokens"] for row in got], "wall_s": wall,
            "launches": launches, "transports": transports}
        del pipe, logits
        torch.cuda.empty_cache()
    # turbo's pipelined forwards at pp = 4: 8 encoder layers and 1 decoder
    # layer on each rank
    mesh = make_mesh(pp=MESH_WORLD)
    local = weights.to_device(shard_params(full, mesh), "cuda")
    del full
    torch.cuda.empty_cache()

    def forwards():
        with torch.inference_mode():
            e = ppl.encoder_forward_pp(local, cfg, torch.from_numpy(mel)
                                       .cuda(), mesh, microbatches=4)
            d = ppl.decoder_logits_pp(local, cfg, torch.from_numpy(pp_tokens)
                                      .cuda(), e, mesh, microbatches=4)
        return e, d

    (e, d), wall, launches, transports = _mesh_timed(kernels, forwards)
    first = dist.get_rank() == 0
    out["pp"] = {"enc": e.cpu().numpy() if first else None,
                 "dec": d.cpu().numpy() if first else None, "wall_s": wall,
                 "launches": launches, "transports": transports}
    del local, e, d
    torch.cuda.empty_cache()
    # tiny's train step at pp = 4 and at (dp, tp) = (2, 2), each against the
    # one-card train_step on the same values, computed here
    tiny = get_config("tiny")
    params = card_init_params(tiny, 2)
    batch = train_batch(tiny, MESH_BATCH, seed=5)
    ref = weights.trainable(params, "cuda")
    ref_out = train.train_step(ref, train.make_optimizer(ref), tiny, batch)
    ref_grads = weights.from_device(weights._map_leaves(lambda t: t.grad,
                                                        ref))
    top = max(float(g.abs().max()) for g in tree_leaves(ref_grads))
    for name, axes in (("train_pp4", {"pp": 4}),
                       ("train_dp2_tp2", {"dp": 2, "tp": 2})):
        mesh = make_mesh(**axes)
        p = weights.trainable(shard_params(params, mesh), "cuda")
        rows = train.TrainBatch(*(shard_tensor(t, ("dp",), mesh)
                                  for t in batch))
        res, wall, launches, transports = _mesh_timed(
            kernels, lambda: ppl.train_step_pp(
                p, train.make_optimizer(p), tiny, rows, mesh,
                microbatches=4 if "pp" in axes else 1))
        err = mesh_max_err(
            weights.from_device(weights._map_leaves(lambda t: t.grad, p)),
            shard_params(ref_grads, mesh))
        loss, ref_loss = float(res["loss"]), float(ref_out["loss"])
        require(abs(loss - ref_loss) <= MESH_LOSS_RTOL * abs(ref_loss),
                f"mesh {name}: loss {loss} != one card's {ref_loss}")
        require(err <= MESH_GRAD_SHARE * top,
                f"mesh {name}: gradient off by {err} (max |g| {top})")
        out[name] = {"loss": loss, "ref_loss": ref_loss, "grad_err": err,
                     "ref_grad_max": top, "wall_s": wall,
                     "launches": launches, "transports": transports}
        del p
    del ref, ref_grads
    # the MoE at ep = 4 against the unsharded layer on the same values
    d_model, d_ff, n_exp, B, T = MESH_MOE
    moe = expert.init_moe_params(
        torch.Generator(device="cuda").manual_seed(6), d_model, d_ff, n_exp)
    x = torch.randn(B, T, d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    mesh = axes_mesh({"dp": 1, "ep": MESH_WORLD})
    local = expert.shard_moe_params(moe, mesh)
    y, wall, launches, _ = _mesh_timed(
        kernels, lambda: expert.moe_mlp_sharded(x, local, mesh))
    err = float((y - expert.moe_mlp(x, moe)).abs().max())
    require(err <= MESH_MOE_ATOL, f"mesh moe: off by {err}")
    out["moe"] = {"err": err, "wall_s": wall, "launches": launches}
    # tiny's checkpoint at tp = 4, restored at (dp, tp) = (2, 2) and whole
    t0 = time.perf_counter()
    m4 = make_mesh(tp=4)
    path = os.path.join(tmp, "dcp_tp4")
    weights.save_dcp(path, shard_params(params, m4), tiny, m4)
    m22 = make_mesh(dp=2, tp=2)
    tp2 = mesh_max_err(weights.load_dcp(path, tiny, m22),
                       shard_params(params, m22)) == 0.0
    whole = (mesh_max_err(weights.load_dcp(path, tiny), params) == 0.0
             if dist.get_rank() == 0 else None)
    require(tp2 and whole is not False, "mesh dcp: a restore differs")
    out["dcp"] = {"tp2": tp2, "whole": whole,
                  "wall_s": time.perf_counter() - t0}
    return out


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name (each counts its launches
    in its `launches` attribute)."""
    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_ragged,
    )
    from whisper_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_bg,
        decode_attention_bh,
        decode_attention_q8,
        decode_attention_q8_bh,
    )
    from whisper_tpu_torch.ops.decoder_step import fused_decoder_step
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_q8,
    )
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    return {"encoder_block_tail": encoder_block_tail,
            "encoder_block_tail_q8": encoder_block_tail_q8,
            "cache_append_rows": cache_append_rows,
            "flash_attention": flash_attention,
            "cache_append_rows_ragged": cache_append_rows_ragged,
            "decode_attention_q8_bh": decode_attention_q8_bh,
            "decode_attention_q8": decode_attention_q8,
            "fused_decoder_step": fused_decoder_step,
            "decode_attention_bh": decode_attention_bh,
            "decode_attention_bg": decode_attention_bg,
            "decode_attention": decode_attention}


def pipeline_layer(card: str) -> None:
    """The pipeline layer's phases alone (--only pipeline): tiny fp32
    long-form against the CPU, the CLI's long WAV and speculative flags,
    speculative decoding at medium, and turbo long-form (weights drawn on
    the card)."""
    import torch

    from whisper_tpu_torch import get_config, weights
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.tokenizer import Tokenizer
    kernels = kernel_wrappers()
    tiny = get_config("tiny")
    longform_fp32_parity(weights.init_params(tiny, seed=0), card)
    cli_longform(card)
    speculative_phase(kernels, card, False)
    tcfg = get_config(TURBO)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = write_v3_vocab(Tokenizer(config=tiny).tokens, tmp)
        pipe = WhisperPipeline.from_params(card_init_params(tcfg, 0), TURBO,
                                           dtype="bfloat16", device="cuda",
                                           vocab_path=vocab, quant="off")
        longform_path(pipe, kernels, card, False)
    del pipe
    torch.cuda.empty_cache()


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
    ap.add_argument("--only", default="",
                    help="comma-separated standalone phases to run alone "
                         f"({', '.join(ONLY)}), after the card and build "
                         f"lines; ends with the ok line but prints no "
                         f"kernels line")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from whisper_tpu_torch import cli, get_config, weights
    from whisper_tpu_torch.config import apply_serving_quant
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.cache_append import (
        cache_append_rows,
        cache_append_rows_plain,
        cache_append_rows_ragged,
    )
    from whisper_tpu_torch.ops.encoder_layer import (
        encoder_block_tail,
        encoder_block_tail_q8,
    )
    from whisper_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_bg,
        decode_attention_bh,
        decode_attention_q8,
        decode_attention_q8_bh,
    )
    from whisper_tpu_torch.ops.decoder_step import fused_decoder_step
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.serving_continuous import ContinuousBatcher

    # the plain fp32 oracles run in full fp32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tiny")
    kernels = kernel_wrappers()
    # every greedy run without the fused step or "pallas" launches none of
    # these
    no_q8 = {"decode_attention_q8_bh": 0, "decode_attention_q8": 0,
             "fused_decoder_step": 0, "encoder_block_tail_q8": 0,
             **NO_DECODE}

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
    if opts.only:
        for name in opts.only.split(","):
            globals()[ONLY[name]](card)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    if opts.profile:
        profile_build(card)

    # 3. kernels against their plain versions at the main paths' shapes
    tail = tail_checks(card)
    tail_gate(card)
    tail8 = tail_int8_checks(card)
    if opts.profile:
        tail_breakdown(card)

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
    # k_new and v_new read once, as many values written; the plain version
    # is the one PyTorch call per cache (an indexed assignment), so it is
    # the library call too
    append_bound = bound(2 * 2 * kn.numel() * kn.element_size(), 0,
                         "bfloat16")

    ragged = ragged_checks(card)
    ragged8 = ragged_int8_checks(card)
    flash = flash_checks(card, opts.profile)
    flash_sass(card)
    q8 = q8_checks(card)
    decode_err = decode_checks(card)
    decode = decode_time(card)
    decode_split_ab(card)
    decode_wall(card)
    if opts.profile:
        decode_split_sweep(card)
    append_int8_checks(card)
    fused_err = fused_checks(card)
    fused = fused_time(card)
    fused_phases(card)

    # 4. tiny main path: the bench workload through the pipeline
    params = weights.init_params(cfg, seed=0)
    pipe = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                       device="cuda", quant="off")
    run, audio, bias, line = main_path(
        pipe, kernels, {"encoder_block_tail": cfg.n_audio_layers,
                        "cache_append_rows": GEN_TOKENS - 1,
                        "flash_attention": 0,
                        "cache_append_rows_ragged": 0, **no_q8}, card)
    tiny_launches = line["launches"]
    main_path_stages(pipe, audio, bias, card)

    # 4-beam. tiny b32 x beam 5 (160 decode rows) through the pipeline,
    # beam 1 against greedy; then sampling through the pipeline and the
    # engine
    beam_main_path(pipe, kernels, BATCH,
                   {"encoder_block_tail": cfg.n_audio_layers}, card,
                   opts.profile)
    sampling(pipe, params, kernels, card)

    # 4'. the same workload with the fused decoder step: one
    # fused_decoder_step and one append launch per loop step
    fpipe = WhisperPipeline.from_params(params, cfg.replace(fused_step=True),
                                        dtype="bfloat16", device="cuda",
                                        quant="off")
    frun, _, _, line = main_path(
        fpipe, kernels, {"fused_decoder_step": GEN_TOKENS - 1,
                         "cache_append_rows": GEN_TOKENS - 1,
                         "encoder_block_tail": cfg.n_audio_layers,
                         "flash_attention": 0, "cache_append_rows_ragged": 0,
                         "decode_attention_q8_bh": 0,
                         "decode_attention_q8": 0, **NO_DECODE}, card,
        label="fused_main_path")
    fused_launches = line["launches"]
    main_path_stages(fpipe, audio, bias, card)
    on_off_ab("fused_ab", {"off": pipe, "on": fpipe}, audio, bias, card)
    if opts.profile:
        profile_path("tiny_fused", cfg, card, frun)
    del fpipe, frun

    # 4''. the same workload under attn_backend "pallas" with
    # WHISPER_TPU_IP_CROSS=bg8: the prefill's T > 1 reads take flash, every
    # layer's bf16 cross read at every loop step decode_attention_bg
    bpipe = EnvPipeline(WhisperPipeline.from_params(
        params, cfg.replace(attn_backend="pallas"), dtype="bfloat16",
        device="cuda", quant="off"), IP_CROSS_BG8)
    brun, _, _, line = main_path(
        bpipe, kernels, {"encoder_block_tail": cfg.n_audio_layers,
                         "flash_attention": 2 * cfg.n_text_layers,
                         "decode_attention_bg":
                         cfg.n_text_layers * (GEN_TOKENS - 1),
                         "cache_append_rows": GEN_TOKENS - 1,
                         "decode_attention_bh": 0, "decode_attention": 0,
                         "cache_append_rows_ragged": 0,
                         "decode_attention_q8_bh": 0,
                         "decode_attention_q8": 0,
                         "fused_decoder_step": 0}, card,
        label="pallas_main_path")
    bg_launches = line["launches"]
    on_off_ab("bg_ab", {"off": pipe, "on": bpipe}, audio, bias, card)
    if opts.profile:
        profile_path("tiny_pallas_bg8", cfg, card, brun)
    del bpipe, brun
    if opts.profile:
        profile_append(card, append_args)
        profile_path("tiny", cfg, card, run)
    bundled_vocab = pipe.tokenizer.tokens
    del run, append_args

    # 4-int8. the encoder's int8 paths: the tail's int8 form, and the int8
    # projections with the tail bypassed
    tail8_launches = encoder_int8_path(pipe, params, kernels, card)

    # 4a. tiny b32 bf16 with the serving policy: weight-only int8 and the
    # int8 cross cache, read scale-commuted (no int8 decode kernel in bf16)
    spipe = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                        device="cuda", quant="auto",
                                        batch_hint=BATCH)
    require(quant_flags(spipe.cfg) == ["weight_quant", "cross_kv_quant"],
            f"tiny b32 bf16 auto quant: {quant_flags(spipe.cfg)}")
    srun, _, _, _ = main_path(
        spipe, kernels, {"encoder_block_tail": cfg.n_audio_layers,
                         "cache_append_rows": GEN_TOKENS - 1,
                         "flash_attention": 0,
                         "cache_append_rows_ragged": 0, **no_q8}, card,
        label="serving_tiny")
    main_path_stages(spipe, audio, bias, card)
    quant_ab({"off": pipe, "auto": spipe}, audio, bias, card)
    if opts.profile:
        profile_path("tiny_serving", cfg, card, srun)
    del pipe, spipe, srun
    torch.cuda.empty_cache()
    serving_logits_vs_cpu(params, "tiny", bench_audio(cfg, 2), card)

    # 4b. tiny continuous engine: 96 requests through 32 slots
    engine = ContinuousBatcher(params, cfg.replace(compute_dtype="bfloat16"),
                               max_slots=BATCH, max_new=ENGINE_MAX_NEW,
                               sync_every=1)
    line, rerun, _ = continuous_run(
        engine, engine_traffic(cfg, ENGINE_REQUESTS, seed=0), kernels,
        "continuous_tiny", card)
    engine_tokens_per_s = line["tokens_per_s"]
    engine_launches = check_engine_launches(line, engine, cfg, 0)
    if opts.profile:
        profile_engine(rerun, line["wall_s"], "tiny", card)
    del engine, rerun
    gc.collect()        # continuous_run's wrappers hold the engine in a cycle
    torch.cuda.empty_cache()

    # 4b'. the same engine and traffic under attn_backend "pallas": every
    # layer's cross read at every step and detect_language's reads take
    # decode_attention_bh, every prefill read flash
    engine = ContinuousBatcher(
        params, cfg.replace(compute_dtype="bfloat16", attn_backend="pallas"),
        max_slots=BATCH, max_new=ENGINE_MAX_NEW, sync_every=1)
    # the rerun closure would hold the engine: dropped at once
    line = continuous_run(
        engine, engine_traffic(cfg, ENGINE_REQUESTS, seed=0), kernels,
        "pallas_engine", card)[0]
    check_engine_launches(line, engine, engine.cfg, 0)
    require(line["detect_language_calls"] > 0,
            "pallas_engine: detect_language never ran")
    del engine, line
    gc.collect()
    torch.cuda.empty_cache()

    # 4b-int8. the engine on int8 caches: tiny and medium under the serving
    # default, tiny fp32 with the int8 cross cache
    medium_ragged, q8_engine_launches, medium_tail8 = continuous_quant(
        params, kernels, engine_tokens_per_s, card, opts.profile)

    # 4c. the engine's tokens: schedule independence and greedy's tokens
    continuous_identity(params, card)

    # 5. tiny fp32 parity: the card against the CPU's plain versions
    clips = bench_audio(cfg, 2)
    p16 = WhisperPipeline.from_params(params, "tiny", dtype="bfloat16",
                                      device="cuda", quant="off")
    tok16 = p16.transcribe_batch(clips, max_new=12).tokens.cpu()
    del p16
    parity = fp32_parity("tiny", params, clips, 12, tok16)
    emit({"phase": "fp32_parity", **parity})
    beam_fp32_parity(params, clips, kernels, card)

    # 5a. tiny fp32 with the fused step: the card against the CPU, and
    # against the card's unfused tokens above
    fcfg = cfg.replace(fused_step=True)
    fparity = fp32_parity(fcfg, params, clips, 12, tok16)
    fparity["tokens_equal_unfused"] = fparity["tokens"] == parity["tokens"]
    fparity["step_logits_max_abs_err"] = fused_step_logit_err(params, fcfg,
                                                              clips)
    emit({"phase": "fused_fp32_parity", **fparity})
    require(fparity["tokens_equal_unfused"],
            "fused fp32 tokens differ from the unfused path's")
    # 1e-4: one fp32 step of logits of order 10 on top of the prefill's
    # own GPU/CPU difference (1e-5 here)
    require(fparity["step_logits_max_abs_err"] < 1e-4,
            f"fused fp32 step logits differ by "
            f"{fparity['step_logits_max_abs_err']}")

    # 5b. tiny b32 fp32 with the int8 cross cache: every layer's cross
    # read at every step is one int8 decode kernel launch; then 2 clips x
    # 12 tokens against the port on the CPU
    qcfg = cfg.replace(cross_kv_quant=True)
    qpipe = WhisperPipeline.from_params(params, qcfg, dtype="float32",
                                        device="cuda", quant="off")
    _, _, _, line = main_path(
        qpipe, kernels, {"decode_attention_q8_bh":
                         cfg.n_text_layers * (GEN_TOKENS - 1),
                         "decode_attention_q8": 0,
                         "fused_decoder_step": 0,
                         "cache_append_rows": GEN_TOKENS - 1,
                         "encoder_block_tail": cfg.n_audio_layers,
                         "flash_attention": 0,
                         "cache_append_rows_ragged": 0, **NO_DECODE}, card,
        label="q8_fp32_main_path")
    q8_launches = line["launches"]
    del qpipe
    torch.cuda.empty_cache()
    parity = fp32_parity(qcfg, params, clips, 12, tok16)
    emit({"phase": "q8_fp32_parity", **parity})

    # 5c. tiny b32 bf16 with kv_cache_quant under "pallas": every T==1
    # step read (self and cross, per layer) dequantizes into
    # decode_attention_bh, the prefill's reads into flash; the steps write
    # their int8 rows in decoder_forward (no append kernel). Then fp32 with
    # the same flags, 2 clips x 12 tokens, against the port on the CPU
    kcfg = cfg.replace(kv_cache_quant=True, attn_backend="pallas")
    kpipe = WhisperPipeline.from_params(params, kcfg, dtype="bfloat16",
                                        device="cuda", quant="off")
    _, _, _, line = main_path(
        kpipe, kernels, {"decode_attention_bh":
                         2 * cfg.n_text_layers * (GEN_TOKENS - 1),
                         "flash_attention": 2 * cfg.n_text_layers,
                         "encoder_block_tail": cfg.n_audio_layers,
                         "cache_append_rows": 0, "decode_attention_bg": 0,
                         "decode_attention": 0, "decode_attention_q8_bh": 0,
                         "decode_attention_q8": 0, "fused_decoder_step": 0,
                         "cache_append_rows_ragged": 0}, card,
        label="pallas_kvq_main_path")
    bh_launches = line["launches"]
    del kpipe
    torch.cuda.empty_cache()
    parity = fp32_parity(kcfg, params, clips, 12, tok16,
                         logit_atol=KVQ_LOGITS_ATOL)
    emit({"phase": "pallas_fp32_parity", **parity})

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
        rc_q = cli.main(["--random-weights", "--audio", path, "--max-new",
                         "8", "--device", "cuda", "--dtype", "bfloat16",
                         "--weight-quant", "--cross-kv-quant",
                         "--self-kv-quant"])
    emit({"phase": "cli", "rc": rc, "rc_quant_flags": rc_q})
    require(rc == 0 and rc_q == 0, f"cli returned {rc}, {rc_q}")
    cli_beam(clips[0], card)

    # 6b. the pipeline layer at tiny: long-form fp32 on the card against
    # the CPU, and the CLI's long WAV and speculative flags
    longform_fp32_parity(params, card)
    cli_longform(card)
    del params
    torch.cuda.empty_cache()

    # 6c. speculative decoding: medium at full width and depth, the tiny
    # draft and medium as its own draft, then under "pallas"
    spec_launches = speculative_phase(kernels, card, opts.profile)

    # 6d. the serving layer: the daemon as a process, turbo behind the HTTP
    # front (the engine and the dynamic batcher), tiny fp32 served on the
    # card against the CPU
    serving = serving_group(card)

    # 6e. fine-tuning: tiny's train steps, its gradients on the card
    # against the CPU, turbo's train steps, the two kernels' backwards
    train = train_group(card)

    # 6f. the meshes: turbo through ShardedPipeline on a world of one NCCL
    # process, then four gloo processes sharing the card (dp/tp/sp, pp,
    # the train step, the MoE, the checkpoint)
    mesh = mesh_group(card)

    # 7. large-v3-turbo at full width and depth: the tail, one launch a
    # layer
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
                                           device="cuda", vocab_path=vocab,
                                           quant="off")
        require(pipe.tokenizer.vocab_size == tcfg.vocab_size,
                "turbo vocab table size")
        run, audio, bias, line = main_path(
            pipe, kernels, {"flash_attention": 0,
                            "encoder_block_tail": tcfg.n_audio_layers,
                            "cache_append_rows": GEN_TOKENS - 1,
                            "cache_append_rows_ragged": 0, **no_q8}, card)
        turbo_launches, turbo_peak = line["launches"], line["peak_mem_gb"]
        main_path_stages(pipe, audio, bias, card)
        # 7-longform. a 75 s clip long-form on the same pipeline
        longform = longform_path(pipe, kernels, card, opts.profile)
        # 7-off. the tail-off encoder (WHISPER_TPU_FUSED_ENCODER=0: flash,
        # then cuBLAS and torch epilogues), its launches, and its wall in
        # turns against the tail
        tail_off = {"WHISPER_TPU_FUSED_ENCODER": "0"}
        opipe = EnvPipeline(pipe, tail_off)
        _, _, _, line = main_path(
            opipe, kernels, {"flash_attention": tcfg.n_audio_layers,
                             "encoder_block_tail": 0,
                             "cache_append_rows": GEN_TOKENS - 1,
                             "cache_append_rows_ragged": 0, **no_q8}, card,
            label="turbo_tail_off")
        tail_off_launches = line["launches"]
        on_off_ab("tail_ab", {"off": opipe, "on": pipe}, audio, bias, card)
        del opipe
        # 7-beam. turbo b8 x beam 5 (40 decode rows), on the same pipeline
        beam_main_path(pipe, kernels, BEAM_TURBO_BATCH,
                       {"encoder_block_tail": tcfg.n_audio_layers}, card,
                       opts.profile)

        # 7'. turbo with the fused step, on the same device params
        fpipe = WhisperPipeline.from_params(
            pipe.params, tcfg.replace(fused_step=True), dtype="bfloat16",
            device="cuda", vocab_path=vocab, quant="off")
        _, _, _, line = main_path(
            fpipe, kernels, {"fused_decoder_step": GEN_TOKENS - 1,
                             "flash_attention": 0,
                             "encoder_block_tail": tcfg.n_audio_layers,
                             "cache_append_rows": GEN_TOKENS - 1,
                             "cache_append_rows_ragged": 0,
                             "decode_attention_q8_bh": 0,
                             "decode_attention_q8": 0, **NO_DECODE}, card,
            label="fused_turbo")
        emit({"phase": "fused_turbo_memory", "peak_mem_gb_fused":
              line["peak_mem_gb"], "peak_mem_gb_unfused": turbo_peak,
              "self_cache_gb_448": 2 * tcfg.n_text_layers * BATCH
              * tcfg.n_heads * 448 * tcfg.head_dim * 2 / 1e9,
              "self_cache_gb_128": 2 * tcfg.n_text_layers * BATCH
              * tcfg.n_heads * 128 * tcfg.head_dim * 2 / 1e9, "card": card})
        main_path_stages(fpipe, audio, bias, card)
        on_off_ab("fused_ab", {"off": pipe, "on": fpipe}, audio, bias,
                  card)
        del fpipe

        # 7''. turbo under "pallas" with WHISPER_TPU_IP_CROSS=bg8, on the
        # same device params: the encoder's and the prefill's reads take
        # flash, every layer's cross read at every step decode_attention_bg
        bpipe = EnvPipeline(WhisperPipeline.from_params(
            pipe.params, tcfg.replace(attn_backend="pallas"),
            dtype="bfloat16", device="cuda", vocab_path=vocab, quant="off"),
            IP_CROSS_BG8)
        main_path(bpipe, kernels,
                  {"flash_attention": 2 * tcfg.n_text_layers,
                   "decode_attention_bg":
                   tcfg.n_text_layers * (GEN_TOKENS - 1),
                   "cache_append_rows": GEN_TOKENS - 1,
                   "encoder_block_tail": tcfg.n_audio_layers,
                   "decode_attention_bh": 0,
                   "decode_attention": 0, "cache_append_rows_ragged": 0,
                   "decode_attention_q8_bh": 0, "decode_attention_q8": 0,
                   "fused_decoder_step": 0}, card, label="pallas_turbo")
        on_off_ab("bg_ab", {"off": pipe, "on": bpipe}, audio, bias, card)
        del bpipe
        if opts.profile:
            profile_path(TURBO, tcfg, card, run)
        clip = bench_audio(tcfg, 1)
        tok16 = pipe.transcribe_batch(clip, max_new=8).tokens.cpu()
        del run, audio, bias

        # 7b. turbo continuous engine, full width and depth, on the
        # pipeline's device params and v3 table
        engine = ContinuousBatcher(pipe.params, pipe.cfg, max_slots=8,
                                   max_new=TURBO_ENGINE_MAX_NEW,
                                   tokenizer=pipe.tokenizer)
        # the rerun closure holds the engine (its params and state):
        # dropped at once, so that later peaks do not count them
        line = continuous_run(
            engine, engine_traffic(tcfg, TURBO_ENGINE_REQUESTS, seed=1),
            kernels, "continuous_turbo", card)[0]
        check_engine_launches(line, engine, tcfg, 0)
        require(line["launches"]["encoder_block_tail"]
                == tcfg.n_audio_layers * line["fills"] > 0,
                "continuous_turbo: not one tail launch per encoder layer")
        del pipe, engine
        gc.collect()
        torch.cuda.empty_cache()

        # 8. turbo fp32 parity, full depth on both sides
        parity = fp32_parity(TURBO, tparams, clip, 8, tok16, vocab)
        emit({"phase": "turbo_fp32_parity", **parity})

        # 8b. turbo b32 bf16 with the serving policy (weight-only int8, the
        # int8 cross cache, the encoder's int8 MLP and o-projection in the
        # tail and its int8 QKV) plus the int8 self cache, at full width
        # and depth
        scfg = apply_serving_quant(
            tcfg.replace(compute_dtype="bfloat16"), batch=BATCH
        ).replace(self_kv_quant=True)
        spipe = WhisperPipeline.from_params(tparams, scfg, dtype="bfloat16",
                                            device="cuda", vocab_path=vocab,
                                            quant="off")
        require(quant_flags(spipe.cfg) == [
            "weight_quant", "cross_kv_quant", "self_kv_quant",
            "encoder_mlp_quant", "encoder_qkv_quant"],
            f"turbo serving quant: {quant_flags(spipe.cfg)}")
        srun, audio, bias, line = main_path(
            spipe, kernels, {"cache_append_rows": GEN_TOKENS - 1,
                             "cache_append_rows_ragged": 0, **no_q8,
                             "flash_attention": 0, "encoder_block_tail": 0,
                             "encoder_block_tail_q8": tcfg.n_audio_layers},
            card, label="serving_turbo")
        serving_turbo_q8 = line["launches"]["encoder_block_tail_q8"]
        L, H, S, D = (tcfg.n_text_layers, tcfg.n_heads, tcfg.n_audio_ctx,
                      tcfg.head_dim)
        emit({"phase": "turbo_memory", "peak_mem_gb_off": turbo_peak,
              "peak_mem_gb_serving": line["peak_mem_gb"],
              "cross_kv_gb_bf16": 2 * L * BATCH * H * S * D * 2 / 1e9,
              "cross_kv_gb_int8": 2 * L * BATCH * H * S * (D + 4) / 1e9,
              "card": card})
        main_path_stages(spipe, audio, bias, card)
        if opts.profile:
            profile_path("large-v3-turbo_serving", tcfg, card, srun)
        del srun
        # the serving policy's encoder with the tail off (flash, the int8
        # flags no-ops) in turns against the int8 tail
        on_off_ab("tail_ab_auto", {"off": EnvPipeline(spipe, tail_off),
                                   "on": spipe}, audio, bias, card)
        opipe = WhisperPipeline.from_params(tparams, TURBO, dtype="bfloat16",
                                            device="cuda", vocab_path=vocab,
                                            quant="off")
        quant_ab({"off": opipe, "auto": spipe}, audio, bias, card)
        del spipe, opipe, audio, bias
        gc.collect()
        torch.cuda.empty_cache()

    # 9. results
    rows = [
        # timed at tiny b32 bf16 (turbo's beside); launches from the tiny
        # main path (turbo's beside)
        {"name": "encoder_block_tail", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "encoder_block_tail"),
         "source": "whisper_tpu_torch/csrc/encoder_tail.cu",
         "replaces": "whisper_tpu/ops/encoder_layer.py:240",
         "launches": tiny_launches["encoder_block_tail"],
         "turbo_launches": turbo_launches["encoder_block_tail"],
         "longform_launches": longform["launches"]["encoder_block_tail"],
         "speculative_launches": spec_launches["encoder_block_tail"],
         **tail},
        # the int8 form (mlp_q, o_q), timed at tiny b32 (turbo's beside);
        # launches from encoder_int8_path (turbo serving's and the medium
        # engine's beside); no one PyTorch call computes it (tail_int8_time
        # gives the composed library calls as context)
        {"name": "encoder_block_tail_q8", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "encoder_block_tail_q8"),
         "source": "whisper_tpu_torch/csrc/encoder_tail.cu",
         "replaces": "whisper_tpu/ops/encoder_layer.py:240",
         "launches": tail8_launches, "turbo_launches": serving_turbo_q8,
         "medium_engine_launches": medium_tail8, **tail8},
        {"name": "cache_append_rows", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "cache_append_rows"),
         "source": "whisper_tpu_torch/csrc/cache_append.cu",
         "replaces": "whisper_tpu/ops/cache_append.py:62",
         "launches": tiny_launches["cache_append_rows"],
         "longform_launches": longform["launches"]["cache_append_rows"],
         "max_abs_err": append_err,
         "ms": append_ms, "plain_ms": append_plain_ms, **append_bound,
         "library_ms": append_plain_ms},
        # launches from the turbo main path with the tail off
        # (WHISPER_TPU_FUSED_ENCODER=0; with the tail on it runs inside
        # the tail, not through this wrapper)
        {"name": "flash_attention", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "flash_attention"),
         "source": "whisper_tpu_torch/csrc/flash_attention.cu",
         "replaces": "whisper_tpu/ops/flash_attention.py:112",
         "launches": tail_off_launches["flash_attention"],
         "speculative_launches": spec_launches["flash_attention"],
         "longform_launches": longform["launches"]["flash_attention"],
         "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
         "shapes": flash["shapes"]},
        {"name": "cache_append_rows_ragged", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "cache_append_rows_ragged"),
         "source": "whisper_tpu_torch/csrc/cache_append.cu",
         "replaces": "whisper_tpu/ops/cache_append.py:133",
         "launches": engine_launches["cache_append_rows_ragged"],
         "max_abs_err": ragged["max_abs_err"], "ms": ragged["ms"],
         "plain_ms": ragged["plain_ms"], "bound_ms": ragged["bound_ms"],
         "bound_by": ragged["bound_by"], "library_ms": ragged["library_ms"]},
        # the int8 instantiation, timed by replay at tiny's engine shape;
        # launches from the medium engine under quant="auto", whose self
        # cache is int8
        {"name": "cache_append_rows_ragged[int8]", "route": "cuda",
         "source": "whisper_tpu_torch/csrc/cache_append.cu",
         "replaces": "whisper_tpu/ops/cache_append.py:133",
         "launches": medium_ragged, **ragged8},
        {"name": "decode_attention_q8_bh", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "decode_attention_q8_bh"),
         "source": "whisper_tpu_torch/csrc/decode_attention.cu",
         "replaces": "whisper_tpu/ops/decode_attention.py:464",
         "launches": q8_launches["decode_attention_q8_bh"],
         # in the fp32 engine on the int8 cross cache (continuous_q8_fp32)
         "engine_launches": q8_engine_launches,
         **q8["decode_attention_q8_bh"]},
        # the JAX package calls decode_attention_q8 from no path (tests
        # only): its launches on the main path are 0
        {"name": "decode_attention_q8", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "decode_attention_q8"),
         "source": "whisper_tpu_torch/csrc/decode_attention.cu",
         "replaces": "whisper_tpu/ops/decode_attention.py:525",
         "launches": q8_launches["decode_attention_q8"],
         **q8["decode_attention_q8"]},
        # timed at tiny b32 bf16, pos 48; its error over fused_vs_plain's
        # tiny b32 bf16 cases; no PyTorch call computes a decoder step
        {"name": "fused_decoder_step", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "fused_decoder_step"),
         "source": "whisper_tpu_torch/csrc/decoder_step.cu",
         "replaces": "whisper_tpu/ops/decoder_step.py:320",
         "launches": fused_launches["fused_decoder_step"],
         **fused, "max_abs_err": fused_err},
        # the three below timed at tiny b32's bf16 cross read (B=32, H=6,
        # 1500 keys); their error over decode_vs_plain's bf16 cases
        {"name": "decode_attention_bh", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "decode_attention_bh"),
         "source": "whisper_tpu_torch/csrc/decode_attention.cu",
         "replaces": "whisper_tpu/ops/decode_attention.py:297",
         "launches": bh_launches["decode_attention_bh"],
         "speculative_launches": spec_launches["decode_attention_bh"],
         "max_abs_err": decode_err["decode_attention_bh"],
         **decode["decode_attention_bh"]},
        {"name": "decode_attention_bg", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "decode_attention_bg"),
         "source": "whisper_tpu_torch/csrc/decode_attention.cu",
         "replaces": "whisper_tpu/ops/decode_attention.py:185",
         "launches": bg_launches["decode_attention_bg"],
         "max_abs_err": decode_err["decode_attention_bg"],
         **decode["decode_attention_bg"]},
        # the JAX package calls decode_attention from no path (tests only):
        # its launches on the main path are 0
        {"name": "decode_attention", "route": "cuda",
         "serving_launches": serving_counts(serving,
                                            "decode_attention"),
         "source": "whisper_tpu_torch/csrc/decode_attention.cu",
         "replaces": "whisper_tpu/ops/decode_attention.py:354",
         "launches": bg_launches["decode_attention"],
         "max_abs_err": decode_err["decode_attention"],
         **decode["decode_attention"]},
    ]
    for row in rows:
        # launches a train step (the backward launches none), tiny's and
        # turbo's
        row["train_launches"] = train["tiny"].get(row["name"], 0)
        row["train_turbo_launches"] = train["turbo"].get(row["name"], 0)
        # each mesh check's launches, by rank
        row["mesh_launches"] = {
            check: [r.get(row["name"], 0) for r in by_rank]
            for check, by_rank in mesh.items()}
    by_name = {row["name"]: row for row in rows}
    by_name["encoder_block_tail"]["train_time"] = \
        train["times"]["encoder_block_tail"]
    by_name["flash_attention"]["train_time"] = {
        k: train["times"][k] for k in ("flash_self", "flash_cross")}
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
