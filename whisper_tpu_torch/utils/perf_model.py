"""Analytic FLOP / HBM-byte cost model of the bench workload
(whisper_tpu/utils/perf_model.py, the same arithmetic), with the peaks of
the port's card.

Per measured run it answers: MFU (the fraction of the card's peak matmul
rate that the measured wall corresponds to) and the speed-of-light
fraction (the roofline floor, summed over the pipeline's phases, over the
measured wall).

Counting conventions:
  * 1 MAC = 2 FLOPs; only matmuls/convs are counted (elementwise stages are
    fused and negligible at these shapes).
  * The HBM floor counts each operand's minimum compressed traffic: weights
    once per *step* (decode) or once per *pass* (encoder/prefill), KV caches
    at their valid lengths, the logit embedding once per step. Activations
    are ignored except where they dominate (encoder scores are not
    materialized on the flash path, so they are not counted).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from whisper_tpu_torch.config import WhisperConfig

# NVIDIA H100 SXM (80GB HBM3) data-sheet peaks, dense, at its full 700 W
# power limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
# outside them (the port's fp32 mode runs with TF32 off), 3.35 TB/s HBM3.
# A card set below 700 W reaches less; nvidia-smi's power.limit says so.
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def default_peak(dtype_bytes: int) -> float:
    """The card's peak matmul rate for a compute dtype of that width."""
    return H100_PEAK_FP32_FLOPS if dtype_bytes == 4 else H100_PEAK_BF16_FLOPS


@dataclasses.dataclass(frozen=True)
class WorkloadCost:
    flops: float                 # total matmul FLOPs for the workload
    hbm_bytes: float             # total minimum HBM traffic
    floor_s: float               # roofline time: sum over phases of
    #                              max(phase_flops/peak, phase_bytes/bw)

    def mfu(self, wall_s: float, peak=H100_PEAK_BF16_FLOPS) -> float:
        return self.flops / wall_s / peak

    def sol_frac(self, wall_s: float) -> float:
        """Speed-of-light fraction: floor time / measured time (1.0 = at
        the roofline)."""
        return self.floor_s / wall_s


def _layer_weight_bytes(cfg: WhisperConfig, cross: bool, dtype_bytes: int
                        ) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    n = 4 * d * d + 2 * d * ff            # qkvo + fc1/fc2
    if cross:
        n += 2 * d * d                    # cross q/o (k/v precomputed)
    return n * dtype_bytes


def _attn_flops(t_q: int, t_kv: int, d: int) -> float:
    """scores + weighted-V over all heads: 2 matmuls of (t_q, dh) x
    (dh, t_kv) per head -> 4 * t_q * t_kv * d total FLOPs."""
    return 4.0 * t_q * t_kv * d


def encoder_cost(cfg: WhisperConfig, batch: int, dtype_bytes: int
                 ) -> tuple[float, float]:
    """(flops, hbm_bytes) for one encoder pass over `batch` rows."""
    d, ff, T = cfg.d_model, cfg.d_ff, cfg.n_audio_ctx
    frames = 2 * T                        # conv2 stride halves 3000 -> 1500
    fl = 2.0 * frames * d * cfg.n_mels * 3          # conv1
    fl += 2.0 * T * d * d * 3                       # conv2
    per_layer = 8.0 * T * d * d + _attn_flops(T, T, d) + 4.0 * T * d * ff
    fl += cfg.n_audio_layers * per_layer
    fl *= batch
    w_bytes = (cfg.n_audio_layers * _layer_weight_bytes(cfg, False, dtype_bytes)
               + (cfg.n_mels * 3 + d * 3) * d * dtype_bytes)
    act_bytes = batch * T * d * dtype_bytes * 2 * cfg.n_audio_layers
    return fl, w_bytes + act_bytes


def prefill_cost(cfg: WhisperConfig, batch: int, prompt_len: int,
                 dtype_bytes: int) -> tuple[float, float]:
    d, ff, S = cfg.d_model, cfg.d_ff, cfg.n_audio_ctx
    L, V, tp = cfg.n_text_layers, cfg.vocab_size, prompt_len
    per_layer = (8.0 * tp * d * d                    # self qkvo
                 + _attn_flops(tp, tp, d)            # causal self
                 + 4.0 * tp * d * d                  # cross q/o
                 + _attn_flops(tp, S, d)             # cross attn
                 + 4.0 * tp * d * ff)                # MLP
    # cross K/V projection of the encoder output happens once (prefill phase)
    cross_proj = 4.0 * S * d * d * L
    fl = batch * (L * per_layer + cross_proj + 2.0 * tp * d * V)
    w = (L * _layer_weight_bytes(cfg, True, dtype_bytes)
         + V * d * dtype_bytes
         + L * 2 * d * d * dtype_bytes)              # cross k/v weights
    cache = batch * L * S * d * 2 * dtype_bytes      # write cross K/V
    return fl, w + cache


def decode_cost(cfg: WhisperConfig, batch: int, prompt_len: int,
                n_steps: int, dtype_bytes: int,
                kv_dtype_bytes: int | None = None,
                cross_kv_bytes: int | None = None,
                weight_dtype_bytes: int | None = None) -> tuple[float, float]:
    """(flops, hbm_bytes) for `n_steps` single-token decode steps.

    Quantized variants shrink the floor honestly: `weight_dtype_bytes`
    covers cfg.weight_quant (int8 decoder weights + tok_emb; per-column
    scales are negligible), `cross_kv_bytes`/`kv_dtype_bytes` cover the
    int8 caches, whose per-vector fp32 scales add 4 bytes per head-slot
    (+6.25% at head_dim 64) and ARE counted."""
    d, ff, S = cfg.d_model, cfg.d_ff, cfg.n_audio_ctx
    L, V, H = cfg.n_text_layers, cfg.vocab_size, cfg.n_heads
    kvb = kv_dtype_bytes or dtype_bytes
    ckb = cross_kv_bytes or dtype_bytes
    wb = weight_dtype_bytes or dtype_bytes
    kv_scale = 4 * H if kvb == 1 else 0       # fp32 scale per (head, slot)
    ck_scale = 4 * H if ckb == 1 else 0
    fl = b = 0.0
    for i in range(n_steps):
        kv_len = prompt_len + i + 1
        per_layer = (12.0 * d * d                    # self qkvo + cross q/o
                     + _attn_flops(1, kv_len, d)
                     + _attn_flops(1, S, d)
                     + 4.0 * d * ff)
        fl += batch * (L * per_layer + 2.0 * d * V)
        step_bytes = (L * _layer_weight_bytes(cfg, True, wb)
                      + V * d * wb                                # logits
                      + batch * L * (2 * S * (d * ckb + ck_scale)
                                     + 2 * kv_len * (d * kvb + kv_scale)))
        b += step_bytes
    return fl, b


def workload_cost(cfg: WhisperConfig, batch: int, prompt_len: int,
                  gen_tokens: int, *, dtype_bytes: int | None = None,
                  peak: Optional[float] = None,
                  bw: float = H100_HBM_BYTES_PER_S) -> WorkloadCost:
    """Roofline cost of the bench workload: encoder pass + prompt prefill +
    (gen_tokens - 1) incremental decode steps (the prefill emits the first
    token's logits). peak: default_peak(dtype_bytes) when None."""
    if dtype_bytes is None:
        dtype_bytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    if peak is None:
        peak = default_peak(dtype_bytes)
    kvb = 1 if (cfg.kv_cache_quant or cfg.self_kv_quant) else dtype_bytes
    ckb = 1 if (cfg.kv_cache_quant or cfg.cross_kv_quant) else dtype_bytes
    wb = 1 if cfg.weight_quant else dtype_bytes
    phases = [
        encoder_cost(cfg, batch, dtype_bytes),
        prefill_cost(cfg, batch, prompt_len, dtype_bytes),
        decode_cost(cfg, batch, prompt_len, gen_tokens - 1, dtype_bytes,
                    kv_dtype_bytes=kvb, cross_kv_bytes=ckb,
                    weight_dtype_bytes=wb),
    ]
    flops = sum(f for f, _ in phases)
    hbm = sum(b for _, b in phases)
    floor = sum(max(f / peak, b / bw) for f, b in phases)
    return WorkloadCost(flops=flops, hbm_bytes=hbm, floor_s=floor)
