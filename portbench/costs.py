"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of Whisper's phases, and the operations and bytes of the encoder tail.

Copied from `whisper_tpu_torch/utils/perf_model.py` (the FLOP counts of
the encoder, the prefill and the decode step) and from `chip_smoke.py`
(`bound`, `tail_q8_bound`, `fused_bound`), so that a later change to the
program cannot change the yardstick. Counting rules:

  * one multiply-add is 2 operations; only matmuls and convolutions count;
  * a roofline bound is the larger of operations over the peak rate of
    their type and bytes over HBM's rate, with each input byte read once
    and each output byte written once;
  * model FLOPs count useful rows only: a padded row of a batch is work
    done, not work wanted;
  * a kernel's bound is reckoned per launch, at the rows and lengths that
    launch computed: its work is not linear in them (the weights are read
    once a launch, whatever its rows).

A config here is a dict with the keys of a `configs/<name>.json` file:
d_model, encoder_attention_heads, encoder_layers, decoder_layers,
num_mel_bins, vocab_size, max_source_positions.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80GB HBM3) data sheet, dense rates at the full 700 W:
# 989 TFLOP/s bf16 on the tensor cores, 1,979 TOP/s int8, 495 TFLOP/s
# TF32, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of HBM3.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def dims(cfg: dict) -> tuple[int, int, int, int, int, int, int]:
    """(d, ff, encoder layers, decoder layers, mels, vocab, audio frames)."""
    d = cfg["d_model"]
    return (d, cfg.get("encoder_ffn_dim", 4 * d), cfg["encoder_layers"],
            cfg["decoder_layers"], cfg["num_mel_bins"], cfg["vocab_size"],
            cfg["max_source_positions"])


def attn_flops(t_q: int, t_kv: int, d: int) -> float:
    """Scores and the weighted sum over all heads: 4 t_q t_kv d."""
    return 4.0 * t_q * t_kv * d


def encoder_flops(cfg: dict, rows: int) -> float:
    """One encoder pass over `rows` 30 s windows: the conv stem, then per
    layer QKV and O (8 T d^2), the attention and the MLP (4 T d ff)."""
    d, ff, la, _, mels, _, t = dims(cfg)
    fl = 2.0 * (2 * t) * d * mels * 3 + 2.0 * t * d * d * 3
    fl += la * (8.0 * t * d * d + attn_flops(t, t, d) + 4.0 * t * d * ff)
    return fl * rows


def cross_kv_flops(cfg: dict, rows: int) -> float:
    """Every decoder layer's cross K and V from the encoder output."""
    d, _, _, lt, _, _, t = dims(cfg)
    return 4.0 * t * d * d * lt * rows


def prefill_flops(cfg: dict, prompt_len: int, rows: int = 1,
                  logits: bool = True) -> float:
    """A prompt of `prompt_len` tokens through the decoder layers (self
    QKVO, causal self attention, cross Q/O, cross attention over the audio
    frames, MLP), with every position's logits when `logits`
    (perf_model's prefill_cost counts them), none without (the engine's
    joined prefill computes no logits). The cross K/V projection is
    `cross_kv_flops`."""
    d, ff, _, lt, _, v, t = dims(cfg)
    p = prompt_len
    per_layer = (8.0 * p * d * d + attn_flops(p, p, d) + 4.0 * p * d * d
                 + attn_flops(p, t, d) + 4.0 * p * d * ff)
    fl = lt * per_layer + (2.0 * p * d * v if logits else 0.0)
    return fl * rows


def decode_step_flops(cfg: dict, kv_len: int, rows: int = 1) -> float:
    """One T==1 step of `rows` rows attending over `kv_len` self positions
    and the audio frames, with its logits."""
    d, ff, _, lt, _, v, t = dims(cfg)
    per_layer = (12.0 * d * d + attn_flops(1, kv_len, d)
                 + attn_flops(1, t, d) + 4.0 * d * ff)
    return (lt * per_layer + 2.0 * d * v) * rows


def batch_flops(cfg: dict, rows: int, prompt_len: int, steps: int) -> float:
    """A greedy batch: encoder, cross K/V, the prompt's prefill with its
    logits, then `steps` T==1 steps (the prefill picks the first token, so
    step i runs at kv_len prompt_len + i + 1)."""
    fl = encoder_flops(cfg, rows) + cross_kv_flops(cfg, rows)
    fl += prefill_flops(cfg, prompt_len, rows)
    for i in range(steps):
        fl += decode_step_flops(cfg, prompt_len + i + 1, rows)
    return fl


def tail_work(cfg: dict, rows: int, int8: bool) -> dict:
    """The encoder tail of one layer over `rows` windows: attention
    (bf16 operations), the o-projection and the MLP (int8 operations in
    the int8 form, else bf16), and its bytes: q, k, v, h in and the
    output in bf16, the three matrices (int8 or bf16), the fp32 vectors
    and, in the int8 form, the column scales."""
    d, ff, _, _, _, _, t = dims(cfg)
    r = rows * t
    mats = d * d + 2 * d * ff
    attn = attn_flops(t, t, d) * rows
    mm = 2.0 * r * mats
    moved = 5 * r * d * 2 + mats * (1 if int8 else 2) + (5 * d + ff) * 4
    if int8:
        moved += (2 * d + ff) * 4
        return {"bf16_ops": attn, "int8_ops": mm, "bytes": moved}
    return {"bf16_ops": attn + mm, "int8_ops": 0.0, "bytes": moved}


def windows_of(grid_y: int, rows_per_block: int, frames: int):
    """The 30 s windows a tail call computed, from the grid of one of its
    row-tiled launches: grid.y is ceil(windows x frames / rows_per_block),
    so the least window count that gives grid_y; None where none does."""
    if grid_y < 1:
        return None
    r = max(1, (grid_y - 1) * rows_per_block // frames)
    while -(-r * frames // rows_per_block) < grid_y:
        r += 1
    return r if -(-r * frames // rows_per_block) == grid_y else None


def fused_step_work(cfg: dict, rows: int, self_len: int) -> dict:
    """One bf16 fused decoder step (every decoder layer in one launch)
    over `rows` rows whose self cache holds `self_len` positions: every
    layer's six matrices (6 d^2 + 2 d ff) and its packed fp32 vectors
    (13 d + ff), the cross K/V of the audio frames and the live self rows
    read once, h in and out and the new K/V rows written once; the
    products and the attention over self_len + 1 self keys and the
    frames."""
    elem = 2
    d, _, _, lt, _, _, t = dims(cfg)
    ff = cfg.get("decoder_ffn_dim", 4 * d)
    mats = 6 * d * d + 2 * d * ff
    moved = (lt * mats * elem + lt * (13 * d + ff) * 4
             + 2 * lt * rows * (t + self_len) * d * elem
             + 2 * rows * d * elem + 2 * lt * rows * d * elem)
    ops = rows * lt * (2.0 * mats + attn_flops(1, self_len + 1, d)
                       + attn_flops(1, t, d))
    return {"bf16_ops": ops, "int8_ops": 0.0, "bytes": moved}


def bound_s(work: dict) -> float:
    """The least time the card could take for `work` ({bf16_ops,
    int8_ops, bytes}): the larger of the operations' time at their peaks
    and the bytes' time at HBM's rate."""
    ops = work["bf16_ops"] / PEAK_BF16 + work["int8_ops"] / PEAK_INT8
    return max(ops, work["bytes"] / HBM_BYTES_PER_S)
