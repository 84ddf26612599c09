"""Whisper encoder and decoder as functions over the params tree
(whisper_tpu/models/whisper.py), fp32 or bf16, with the JAX package's
int8 serving stack: weight-only int8 decoder linears (`w_s` per output
column, `tok_emb_s` per row), int8 K/V caches with per-vector fp32 scales
({"k", "k_s", "v", "v_s"}) for the cross cache, the self cache or both
(in the greedy step and the engine's ragged step), and the encoder's int8
paths (`linear_i8dyn`; the tail kernel's int8 form).

The params tree and every layout are the JAX package's: layers stacked on
a leading L axis, linear weights (in, out), q (B, T, H, D), K/V and the
caches head-major (L, B, H, S, D). Where JAX scans the layers, the port
loops over them in Python.

Attention takes cfg.attn_backend as the JAX model does (ops/attention.py:
"reference", "pallas", "pallas_interpret", "auto"; None defers to
WHISPER_TPU_ATTN, then "auto"): every `_cache_attention` read (prefills,
the kv_cache_quant steps, detect_language, the engine's cross read) and
the tail-off encoder's attention pass it on, and "reference" turns the
encoder's tail kernel off. int8 reads follow the JAX routes. bf16 mode
reads an int8 cross or self cache scale-commuted (`_att_cross_q8`,
`_self_attention_extra_q8`: the scales multiply scores and probabilities,
no dequantized cache exists); fp32 mode reads an int8 cross cache through
decode_attention_q8_bh (the hand-written kernel on CUDA, its plain
version on the CPU) unless the backend is "reference"; prefills and
kv_cache_quant steps dequantize (`_cache_attention` →
multi_head_attention_quant). decoder_step_ip's bf16 unquantized cross
read takes decode_attention_bg under WHISPER_TPU_IP_CROSS=bg[N]. The int8
weights are dequantized at every call (`_wq_dequant`), where XLA fuses
the dequantization into the product's operand read: on the card that
writes a copy of each weight in the compute dtype per step.

Differences from the JAX module, all deliberate:
  * The self cache is updated IN PLACE: decoder_forward writes the prompt
    rows into the given tensors and decoder_step_ip appends with the
    in-place kernel; both also return the cache for symmetry with JAX.
    Under autograd (the train step) decoder_forward writes nothing in
    place and returns a new cache, as JAX's does.
  * Outside the fused step (decode._make_fused_step, one
    fused_decoder_step launch for every layer) the decode step is
    decoder_step_ip (read-only cache inside the layer loop, the current
    token as an extra softmax term, one append after the loop), in fp32
    as in bf16; the JAX package runs decoder_step_t in fp32 and pins the
    append-first step in its tests (tests/test_cache_append.py:129-199).
  * fp32 products run in full fp32 only with TF32 off on the card
    (`full_fp32`): JAX runs HIGHEST precision at every fp32 product.
  * Self-attention reads one fused (d, 3d) `qkv` linear, which
    weights.to_device builds once; JAX concatenates q/k/v under jit.
  * The encoder takes the fused tail kernel at every width its tiles take
    (every Whisper width, fp32 included) and the JAX tail-off branch
    under "reference" or WHISPER_TPU_FUSED_ENCODER=0
    (`_encoder_tail_mode`); the JAX gate weighs TPU VMEM budgets instead,
    which refuse turbo's width in fp32.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.ops.attention import (
    default_backend,
    multi_head_attention,
    multi_head_attention_quant,
)
from whisper_tpu_torch.ops.cache_append import (
    cache_append_rows,
    cache_append_rows_ragged,
    set_rows,
)
from whisper_tpu_torch.ops.decode_attention import (
    decode_attention_bg,
    decode_attention_q8_bh,
)
from whisper_tpu_torch.ops.encoder_layer import (
    encoder_block_tail,
    encoder_block_tail_q8,
    qdot,
    tail_fits_smem,
)
from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.ops.grad import tracks_grad

Params = Any    # nested dict of torch tensors
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: WhisperConfig) -> torch.dtype:
    try:
        return _DTYPES[str(cfg.compute_dtype)]
    except KeyError:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port runs "
                         f"{sorted(_DTYPES)}") from None


_fp32_lock = threading.Lock()
_fp32_depth = 0           # blocks open with `on`, across every thread
_fp32_saved: tuple = ()   # the flags as the outermost such block found them


@contextlib.contextmanager
def full_fp32(on: bool = True):
    """TF32 trap: cuDNN runs fp32 convolutions in TF32 by default, and TF32
    keeps ~3 decimal digits, enough to flip fp32 token parity. JAX runs
    the conv stem (:404-409), the mel matmuls and the logits at HIGHEST
    precision, so inside this block (when `on`) TF32 is off for matmuls
    and cuDNN alike.

    The flags are process-global, so the blocks are counted across
    threads: the first to open saves the caller's settings and turns TF32
    off, the last to close restores them. Two device threads in fp32 (two
    servers in one process) cannot then switch TF32 back on under each
    other."""
    global _fp32_depth, _fp32_saved
    if not on:
        yield
        return
    matmul = torch.backends.cuda.matmul
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = (matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
        _fp32_depth += 1
        matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
                    _fp32_saved


# ---------------------------------------------------------------------------
# tensor and sequence parallelism (parallel/: the meshes)
# ---------------------------------------------------------------------------

_shard = threading.local()     # .groups: (tp group, sp group) of this thread


@contextlib.contextmanager
def sharded(tp=None, sp=None):
    """Run the model's functions on a rank's shard: `tp` and `sp` are the
    mesh's process groups (None, or a group of one rank, for an axis that
    is not split). The params are the rank's local tree
    (parallel/mesh.shard_params, then weights.to_device) and the inputs
    its rows. Inside the block, on this thread:
      * tp: every self and cross attention runs on the rank's n_heads / tp
        heads (`local_heads`; head_dim stays d_model / n_heads); the
        row-parallel products (the o-projections, fc2) sum their partial
        products over tp and add the bias once (`linear_row`); the token
        embedding is a masked lookup of the rank's vocab rows summed over
        tp, and the logits are the rank's vocab slice gathered over tp
        and cut to cfg.vocab_size, so every rank takes the same argmax.
        The encoder's fused tail is off (it fuses the o-projection's sum
        into one launch): each rank launches the flash kernel on its heads
        through the tail-off branch. The fused decoder step raises.
      * sp: the encoder runs its stem whole, keeps the rank's frames,
        gathers every layer's keys and values over sp (each rank's
        queries read all 1500 frames), and gathers its output before the
        decoder, which runs whole on every sp rank.
    The groups reach the model through this thread-local block (as the
    fp32 switch `full_fp32` is a block), not through arguments, so that
    the decode loops run unchanged; each model function reads them once
    per call (`tp_linears`, `local_heads`), and outside the block the
    layers call the plain `linear`. Under autograd the collectives carry
    Megatron's gradients (ops/collectives.py)."""
    saved = getattr(_shard, "groups", (None, None))
    _shard.groups = tuple(g if collectives.size(g) > 1 else None
                          for g in (tp, sp))
    try:
        yield
    finally:
        _shard.groups = saved


def tp_group():
    """The tp group of the enclosing `sharded` block (None outside, or
    for one rank)."""
    return getattr(_shard, "groups", (None, None))[0]


def sp_group():
    """The sp group of the enclosing `sharded` block (None outside, or
    for one rank)."""
    return getattr(_shard, "groups", (None, None))[1]


def local_heads(cfg: WhisperConfig, tp) -> int:
    """Attention heads on a rank of tp group `tp`: n_heads / tp."""
    return cfg.n_heads // collectives.size(tp)


def linear_col(x: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """A column-parallel product (q/k/v, fc1, the cross q/k/v): the rank's
    output columns of a replicated input. Under autograd the input's
    gradient is summed over tp group `tp`."""
    return linear(collectives.copy_to(x, tp), p)


def linear_row(x: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """A row-parallel product (the o-projections, fc2): x holds the rank's
    slice of the input features; the partial products are summed over tp
    group `tp`, then the bias is added once."""
    if "w_s" in p:
        raise NotImplementedError("an int8 linear under tp > 1 (shard the "
                                  "unquantized tree)")
    return collectives.reduce_from(x @ p["w"], tp) + p["b"]


def tp_linears(tp):
    """(column-parallel, row-parallel) products for tp group `tp`, read
    once per model call: the plain `linear` for both when tp is None, so
    the unsharded layers make no extra call."""
    if tp is None:
        return linear, linear
    return (functools.partial(linear_col, tp=tp),
            functools.partial(linear_row, tp=tp))


def layer_index(tree, i: int):
    """Layer i of a stacked (leading-L) params subtree."""
    if isinstance(tree, dict):
        return {k: layer_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_leaves(tree):
    """The leaves of a nested dict, in its key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# primitives (whisper_tpu/models/whisper.py:52-184)
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Row-wise LayerNorm, computed in fp32 whatever the activation dtype
    (:52-60), returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GeLU (:63), not the tanh approximation."""
    return F.gelu(x)


def _wq_dequant(p: Params, dtype) -> torch.Tensor:
    """Effective weight of an int8 linear ({"w": int8 (..., in, out),
    "w_s": fp32 (..., out)}): the values and the per-column scale, each
    cast to the compute dtype, multiplied and rounded there (:68)."""
    return p["w"].to(dtype) * p["w_s"].to(dtype).unsqueeze(-2)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b with w stored (in, out); an int8 linear (with "w_s")
    dequantizes first (:82)."""
    w = _wq_dequant(p, x.dtype) if "w_s" in p else p["w"]
    return x @ w + p["b"]


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, d) -> (B, T, H, Dh), the query layout."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def split_heads_hm(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, d) -> (B, H, S, Dh), the head-major key/value layout."""
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def qkv_fused(y: torch.Tensor, attn: Params, n_heads: int, col=linear
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (d -> 3d) projection through the fused `qkv` linear that
    weights.to_device builds, then split (:89): q (B,T,H,Dh), k and v
    (B,H,T,Dh). `col`: the column-parallel product of `tp_linears` (under
    tp, the rank's heads)."""
    q, k, v = col(y, attn["qkv"]).chunk(3, dim=-1)
    return (split_heads(q, n_heads), split_heads_hm(k, n_heads),
            split_heads_hm(v, n_heads))


def sinusoidal_positions(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal encoder positions (:351), fp32."""
    log_timescale = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.tensor(np.concatenate([np.sin(scaled), np.cos(scaled)], 1),
                        dtype=torch.float32)


# ---------------------------------------------------------------------------
# weight-only int8 (:199-265)
# ---------------------------------------------------------------------------

def _int8_symmetric(x: torch.Tensor, dim: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim`, in the JAX package's order so that the
    values are its bit for bit: max|x| / 127, at least 1e-10, divide,
    round half to even, clip. Returns (int8 values, fp32 scales with
    `dim` kept). The divide, round and clip run in place on one fp32
    copy of x, where XLA fuses them."""
    xf = x.to(torch.float32, copy=True)
    s = torch.clamp_min(xf.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-10)
    return xf.div_(s).round_().clamp_(-127, 127).to(torch.int8), s


def _quant_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column int8 over the reduction (in) axis (:203):
    (..., in, out) -> (int8 values, fp32 scales (..., out))."""
    q, s = _int8_symmetric(w, -2)
    return q, s.squeeze(-2)


def linear_i8dyn(x: torch.Tensor, p: Params, dtype) -> torch.Tensor:
    """The encoder's int8 linear (:124, cfg.encoder_quant): the tail's
    `qdot` (x quantized per row, the weight per output column, quantized
    here unless it already is; the exact int32 product, which an fp32
    product of int8 values is not once K x 127^2 passes 2^24, as at
    turbo's K of 1,280 and 5,120; the rescale by row scale x column scale
    in fp32), cast to `dtype`, plus the bias with torch's promotion,
    which is JAX's (:143): a bf16 bias gives bf16, an fp32 one fp32."""
    if "w_s" in p:
        wq, ws = p["w"], p["w_s"]
    else:
        wq, ws = _quant_cols(p["w"])
    return qdot(x.float(), wq.t(), ws).to(dtype) + p["b"]


def qkv_fused_i8dyn(y: torch.Tensor, attn: Params, n_heads: int, dtype
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 form of qkv_fused (:146): one linear_i8dyn over the fused
    `qkv` linear (its per-column quantization gives q's, k's and v's
    values and scales side by side, as JAX's concatenation does), then the
    split."""
    q, k, v = linear_i8dyn(y, attn["qkv"], dtype).chunk(3, dim=-1)
    return (split_heads(q, n_heads), split_heads_hm(k, n_heads),
            split_heads_hm(v, n_heads))


def quantize_weights_wq(params: Params, cfg: WhisperConfig) -> Params:
    """Weight-only int8 for the decoder's per-step weights (:212): the
    self-attention projections, cross-attention q and o, fc1 and fc2 per
    output column; tok_emb per row (`tok_emb_s`, the tied logits'
    output-column axis). Cross-attention k/v, the encoder, biases,
    LayerNorms and positions stay as they are. Quantize AFTER the cast to
    the compute dtype, as the JAX pipeline does (pipeline.py:90-97): the
    int8 values of bf16 and fp32 weights differ.

    The port's fused self-attention `qkv` linear (weights.to_device) is
    quantized per column like any other, which gives q, k and v's int8
    values and their three scale vectors concatenated. A linear that is
    already int8 is kept. bf16 serving mode only: fp32 raises."""
    if compute_dtype(cfg) == torch.float32:
        raise ValueError("weight_quant is the serving-mode (bf16) feature; "
                         "fp32 is the token-parity contract")

    def qlin(p):
        if "w_s" in p:
            return p
        q, s = _quant_cols(p["w"])
        return {"w": q, "w_s": s, "b": p["b"]}

    dec = params["decoder"]
    layers = dict(dec["layers"])
    layers["attn"] = {n: qlin(p) for n, p in layers["attn"].items()}
    layers["cross_attn"] = {**layers["cross_attn"],
                            "q": qlin(layers["cross_attn"]["q"]),
                            "o": qlin(layers["cross_attn"]["o"])}
    layers["fc1"] = qlin(layers["fc1"])
    layers["fc2"] = qlin(layers["fc2"])
    dec = {**dec, "layers": layers}
    if "tok_emb_s" not in dec:
        q, s = _int8_symmetric(dec["tok_emb"], -1)
        dec["tok_emb"], dec["tok_emb_s"] = q, s.squeeze(-1)
    return {**params, "decoder": dec}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def conv_stem(enc: Params, cfg: WhisperConfig, mel: torch.Tensor
              ) -> torch.Tensor:
    """(B, n_mels, n_frames) -> (B, T, d): conv k3 s1 -> GeLU -> conv k3
    s2 -> GeLU (:366, the default `conv` form). The bias is added after
    the convolution in the compute dtype, as the JAX stem does."""
    dtype = compute_dtype(cfg)

    def conv(x, p, stride):
        y = F.conv1d(x, p["w"].to(dtype), stride=stride, padding=1)
        return y + p["b"].to(dtype)[None, :, None]

    x = gelu(conv(mel.to(dtype), enc["conv1"], 1))
    x = gelu(conv(x, enc["conv2"], 2))
    return x.transpose(1, 2)


def _encoder_tail_mode(cfg: WhisperConfig, device: torch.device,
                       mlp_q: bool = False) -> str:
    """'off' under the "reference" attention backend (cfg.attn_backend,
    else WHISPER_TPU_ATTN) or with WHISPER_TPU_FUSED_ENCODER=0, as in the
    JAX gate (:431-434). Otherwise 'tail' where the fused tail kernel
    takes the model's width on this device in the form the encoder runs
    (`mlp_q`: the int8 form, whose gate JAX's tail_fits_vmem also takes,
    :443-449): every Whisper width, tiny up to large and turbo, in either
    form (`tail_fits_smem`), and 'off' past the kernel's widths. The
    port's rule stands in for the JAX gate's size and VMEM tests
    (:435-451), which are TPU calibration; WHISPER_TPU_FUSED_ENCODER=1
    (JAX: on whatever the size) and "pallas" (JAX: on at every width) give
    the same answer, since the rule takes every width the kernel runs. The
    CPU answers as an H100 would, so both devices run the same branch.
    Inside a `sharded` block with tp > 1 the answer is 'off': the kernel
    fuses the o-projection, whose partial products a tp shard must sum
    first."""
    backend = cfg.attn_backend or default_backend()
    if (os.environ.get("WHISPER_TPU_FUSED_ENCODER") == "0"
            or backend == "reference" or tp_group() is not None):
        return "off"
    return ("tail" if tail_fits_smem(cfg.d_model, cfg.d_ff, device, mlp_q)
            else "off")


def _env_flag(name: str, default: bool) -> bool:
    """An encoder int8 flag with its environment override, read as JAX
    reads it (:454-481): when the variable is set, "1" turns the path on
    and any other value off. JAX reads it at trace time, the port at every
    call, which for a fixed process is the same."""
    env = os.environ.get(name)
    return default if env is None else env == "1"


def _encoder_i8(cfg: WhisperConfig) -> bool:
    """cfg.encoder_quant, overridden by WHISPER_TPU_ENC_I8 (:454)."""
    return _env_flag("WHISPER_TPU_ENC_I8", cfg.encoder_quant)


def _encoder_i8k(cfg: WhisperConfig) -> bool:
    """cfg.encoder_mlp_quant, overridden by WHISPER_TPU_ENC_I8K (:464)."""
    return _env_flag("WHISPER_TPU_ENC_I8K", cfg.encoder_mlp_quant)


def _encoder_i8q(cfg: WhisperConfig) -> bool:
    """cfg.encoder_qkv_quant, overridden by WHISPER_TPU_ENC_I8Q (:474)."""
    return _env_flag("WHISPER_TPU_ENC_I8Q", cfg.encoder_qkv_quant)


def _tail_q8_weights(layers: Params, o_q: bool, dtype) -> Params:
    """The int8 tail's stacked matrices, once per encoder call, as JAX
    quantizes them (:511-518, :552-561): fc1 and fc2 per output column,
    and wo too under o_q (else wo in the compute dtype), each transposed
    once to the K-major (L, out, in) layout the kernel reads."""
    def kmajor(w):
        return w.transpose(-1, -2).contiguous()

    f1q, f1s = _quant_cols(layers["fc1"]["w"])
    f2q, f2s = _quant_cols(layers["fc2"]["w"])
    out = {"fc1": kmajor(f1q), "fc1_s": f1s, "fc2": kmajor(f2q),
           "fc2_s": f2s, "wo_s": None}
    wo = layers["attn"]["o"]["w"]
    if o_q:
        woq, out["wo_s"] = _quant_cols(wo)
        out["wo"] = kmajor(woq)
    else:
        out["wo"] = kmajor(wo.to(dtype))
    return out


def encoder_forward(params: Params, cfg: WhisperConfig, mel: torch.Tensor
                    ) -> torch.Tensor:
    """(B, n_mels, n_frames) -> (B, n_audio_ctx, d_model) (:484): the conv
    stem and positions (`encoder_input`), then `encoder_blocks`."""
    return encoder_blocks(params, cfg,
                          encoder_input(params["encoder"], cfg, mel))


def encoder_blocks(params: Params, cfg: WhisperConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """The encoder after its input: (B, n_audio_ctx, d_model) ->
    (B, n_audio_ctx, d_model).

    Per block: LN1 and the fused QKV projection in torch, then either the
    fused block tail (attention, o-projection, LN2, MLP; the CUDA kernel
    for CUDA tensors, its plain twin on the CPU) or, when the tail is off
    (`_encoder_tail_mode`), the JAX tail-off branch (:572-578): attention
    through multi_head_attention under cfg.attn_backend (the flash kernel
    at every encoder size, but under "reference"), the o-projection, LN2
    in fp32 and the MLP in the compute dtype.
    Then the final LayerNorm.

    The int8 paths, bf16 only (fp32 ignores all three flags, as JAX does),
    each flag with its environment override (`_encoder_i8*`):
      * encoder_quant (:526-536): the four projections are linear_i8dyn
        (qkv_fused_i8dyn for QKV) and the tail is bypassed;
      * encoder_mlp_quant, where the tail runs: the tail's int8 form
        (encoder_block_tail_q8) with fc1 and fc2 int8, and wo int8 too
        unless WHISPER_TPU_ENC_I8O=0 (:552-562), quantized once per call;
      * encoder_qkv_quant, with encoder_mlp_quant where the tail runs: the
        QKV projection in front of the tail is qkv_fused_i8dyn (:537-543).
    The tail runs at every Whisper width, so the serving policy's
    encoder_mlp_quant (from d = 768) and encoder_qkv_quant (from d = 1024)
    take effect there; where the tail is off (WHISPER_TPU_FUSED_ENCODER=0,
    "reference") the two tail flags are no-ops, as in JAX's tail-off
    branch."""
    enc = params["encoder"]
    dtype = compute_dtype(cfg)
    quant = dtype != torch.float32
    enc_i8 = quant and _encoder_i8(cfg)
    tp, sp = tp_group(), sp_group()
    col, row = tp_linears(tp)
    heads = local_heads(cfg, tp)
    if enc_i8 and tp is not None:
        raise NotImplementedError(
            "encoder_quant under tp > 1: its row-parallel products quantize "
            "each row over the full input width, which a tp shard lacks")
    enc_i8k = quant and not enc_i8 and _encoder_i8k(cfg)
    tail = "off" if enc_i8 else _encoder_tail_mode(cfg, x.device, enc_i8k)
    enc_i8k = enc_i8k and tail == "tail"
    if enc_i8k:
        mlpq = _tail_q8_weights(
            enc["layers"],
            os.environ.get("WHISPER_TPU_ENC_I8O", "1") != "0", dtype)
    for i in range(cfg.n_audio_layers):
        lp = layer_index(enc["layers"], i)
        y = layer_norm(x, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        if enc_i8 or (enc_i8k and _encoder_i8q(cfg)):
            q, k, v = qkv_fused_i8dyn(y, lp["attn"], heads, dtype)
        else:
            q, k, v = qkv_fused(y, lp["attn"], heads, col)
        if sp is not None:
            k, v = (collectives.gather_partial(t, sp, 2) for t in (k, v))
        if enc_i8:
            a = multi_head_attention(q, k, v, backend=cfg.attn_backend)
            x = x + linear_i8dyn(merge_heads(a), lp["attn"]["o"], dtype)
            y = layer_norm(x, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"],
                           cfg.ln_eps)
            x = x + linear_i8dyn(gelu(linear_i8dyn(y, lp["fc1"], dtype)),
                                 lp["fc2"], dtype)
            continue
        if tail == "tail":
            vecs = (lp["attn"]["o"]["b"], lp["fc1"]["b"], lp["fc2"]["b"],
                    lp["mlp_ln"]["g"], lp["mlp_ln"]["b"])
            qkvh = (q.contiguous(), k.contiguous(), v.contiguous(),
                    x.contiguous())
            if enc_i8k:
                wo_s = mlpq["wo_s"]
                x = encoder_block_tail_q8(
                    *qkvh, mlpq["wo"][i], mlpq["fc1"][i], mlpq["fc2"][i],
                    *vecs, mlpq["fc1_s"][i], mlpq["fc2_s"][i],
                    None if wo_s is None else wo_s[i], eps=cfg.ln_eps)
            else:
                x = encoder_block_tail(
                    *qkvh, lp["attn"]["o"]["w"].to(dtype),
                    lp["fc1"]["w"].to(dtype), lp["fc2"]["w"].to(dtype),
                    *vecs, eps=cfg.ln_eps)
            continue
        a = multi_head_attention(q, k, v, backend=cfg.attn_backend)
        x = x + row(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(x, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        x = x + row(gelu(col(y, lp["fc1"])), lp["fc2"])
    return encoder_output(enc, cfg, x)


def encoder_input(enc: Params, cfg: WhisperConfig, mel: torch.Tensor
                  ) -> torch.Tensor:
    """The blocks' input: the conv stem plus the positions, (B,
    n_audio_ctx, d). Under sp the stem runs whole (a sliced stem would
    need halo frames, and it is cheap) and this rank keeps its frames."""
    x = conv_stem(enc, cfg, mel) + enc["pos_emb"].to(compute_dtype(cfg))
    g = sp_group()
    if g is None:
        return x
    n = collectives.size(g)
    if x.shape[1] % n:
        raise ValueError(f"sp={n} does not divide {x.shape[1]} encoder "
                         f"frames")
    return x.chunk(n, dim=1)[collectives.rank(g)]


def encoder_output(enc: Params, cfg: WhisperConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """The final LayerNorm; under sp every rank's frames, gathered."""
    x = layer_norm(x, enc["ln_post"]["g"], enc["ln_post"]["b"], cfg.ln_eps)
    return collectives.gather_from(x, sp_group(), 1)


# ---------------------------------------------------------------------------
# decoder + KV cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 (:589): (..., D) -> (int8 values, fp32
    scale (..., 1))."""
    return _int8_symmetric(x, -1)


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
                  s_max: int, device) -> dict[str, torch.Tensor]:
    """Zeroed self-attention cache {"k", "v"}, each (L, B, H, s_max, Dh)
    (:620). s_max right-sizes the slots to what the decode can reach
    (decode._cache_slots). With kv_cache_quant, or self_kv_quant outside
    fp32 (fp32 ignores it), the values are int8 and the per-vector scales
    {"k_s", "v_s"} (L, B, H, s_max, 1) fp32 start at 1e-10."""
    shape = (cfg.n_text_layers, batch, local_heads(cfg, tp_group()), s_max,
             cfg.head_dim)
    if cfg.kv_cache_quant or (cfg.self_kv_quant and dtype != torch.float32):
        def scales():
            return torch.full(shape[:-1] + (1,), 1e-10, dtype=torch.float32,
                              device=device)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": scales(),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_s": scales()}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params: Params, cfg: WhisperConfig,
                        enc_out: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V, once per transcription
    (:654): {"k", "v"} each (L, B, H, n_audio_ctx, Dh); int8 with
    per-vector scales {"k_s", "v_s"} under kv_cache_quant or
    cross_kv_quant (:669-672)."""
    layers = params["decoder"]["layers"]
    quant = cfg.kv_cache_quant or cfg.cross_kv_quant
    out = {name: [] for name in (("k", "k_s", "v", "v_s") if quant
                                 else ("k", "v"))}
    tp = tp_group()
    col, _ = tp_linears(tp)
    heads = local_heads(cfg, tp)
    for i in range(cfg.n_text_layers):
        ca = layer_index(layers["cross_attn"], i)
        for name in ("k", "v"):
            x = split_heads_hm(col(enc_out, ca[name]), heads)
            if quant:       # layer by layer: fp32 temporaries of one layer
                x, x_s = quantize_kv(x)
                out[name + "_s"].append(x_s)
            out[name].append(x)
    return {name: torch.stack(xs) for name, xs in out.items()}


def _cache_attention(q: torch.Tensor, entry: dict[str, torch.Tensor],
                     kv_len, *, causal: bool, q_offset: int,
                     cfg: WhisperConfig, dtype) -> torch.Tensor:
    """Attention over one layer's cache slice `entry` ({"k", "v"}, plus
    {"k_s", "v_s"} when int8) under cfg.attn_backend (:605-617): an int8
    slice goes through multi_head_attention_quant, a plain one through
    multi_head_attention with K/V in the compute dtype."""
    if "k_s" in entry:
        return multi_head_attention_quant(
            q, entry["k"], entry["k_s"], entry["v"], entry["v_s"], kv_len,
            causal=causal, q_offset=q_offset, backend=cfg.attn_backend)
    return multi_head_attention(q, entry["k"].to(dtype), entry["v"].to(dtype),
                                kv_len, causal=causal, q_offset=q_offset,
                                backend=cfg.attn_backend)


def tok_embed(dec: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding; an int8 table's rows take their per-row scale
    after the gather (:187). Under tp the table holds this rank's vocab
    rows: the lookup takes the tokens that fall in them, zeros for the
    rest, and sums over tp (one rank holds each row)."""
    g = tp_group()
    if g is not None:
        if "tok_emb_s" in dec:
            raise NotImplementedError("an int8 token table under tp > 1")
        rows = dec["tok_emb"].shape[0]
        local = tokens - rows * collectives.rank(g)
        hit = (local >= 0) & (local < rows)
        e = dec["tok_emb"][local.clamp(0, rows - 1)].to(dtype)
        return collectives.reduce_from(
            torch.where(hit.unsqueeze(-1), e, torch.zeros_like(e)), g)
    e = dec["tok_emb"][tokens].to(dtype)
    if "tok_emb_s" in dec:
        return e * dec["tok_emb_s"][tokens].unsqueeze(-1).to(dtype)
    return e


def final_logits(params: Params, cfg: WhisperConfig, h: torch.Tensor
                 ) -> torch.Tensor:
    """Final LayerNorm + tied-embedding logits, (B, T, d) -> (B, T, vocab)
    in fp32 (:756).

    bf16-logits trap: JAX multiplies the bf16 h by the bf16 embedding
    with fp32 accumulation and an fp32 result (:784-785). A bf16
    torch.matmul would round the logits to bf16 and make argmax ties, so
    both operands are upcast: bf16 x bf16 products are exact in fp32, so
    this is the same sum with an fp32 output. In fp32 mode it is the
    HIGHEST-precision product (:772-774). An int8 table is dequantized
    per row in the compute dtype first (:775-782).

    Under tp each rank multiplies by its vocab rows; the slices are
    gathered over tp. A table padded past cfg.vocab_size (the tp shards'
    zero rows) gives exact-zero logits there, cut off here."""
    dec = params["decoder"]
    g = tp_group()
    h = layer_norm(h, dec["ln"]["g"], dec["ln"]["b"], cfg.ln_eps)
    emb = dec["tok_emb"]
    if "tok_emb_s" in dec:
        dtype = compute_dtype(cfg)
        emb = emb.to(dtype) * dec["tok_emb_s"].unsqueeze(-1).to(dtype)
    logits = collectives.gather_from(
        collectives.copy_to(h.float(), g) @ emb.float().t(), g, -1)
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def decoder_forward(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                    pos_offset: int, kv_cache: dict[str, torch.Tensor],
                    cross_kv: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decoder pass over T tokens at positions [pos_offset,
    pos_offset + T) (:676): the prompt prefill, and every step under
    kv_cache_quant. Writes the new K/V rows into kv_cache in place
    (quantized first into an int8 cache, :708-721), then attends with the
    (kv_len, causal, q_offset) mask through `_cache_attention`, as JAX
    does (:731-741). Returns (logits (B, T, vocab) fp32, kv_cache).

    Under autograd (grad mode on and a decoder parameter or the cross K/V
    requiring grad: the train step) nothing is written in place: an
    in-place row write would change the cache that an earlier layer's
    attention saved for its backward. Each layer's K/V are then the
    cache's slots with the new rows scattered in out of place, read with
    the same extent (every slot, kv_len = pos_offset + T), and the cache
    that comes back is a new one holding the same values; the given
    tensors are left as they were. An int8 cache raises there."""
    h, kv_cache = _decoder_layers(params, cfg, tokens, pos_offset, kv_cache,
                                  cross_kv)
    return final_logits(params, cfg, h), kv_cache


def decoder_hidden(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                   pos_offset: int, kv_cache: dict[str, torch.Tensor],
                   cross_kv: dict[str, torch.Tensor]) -> torch.Tensor:
    """decoder_forward's layers without the final LayerNorm and logits:
    fills kv_cache in place and returns h (B, T, d). The engine's batched
    prefill calls it alone, where JAX leaves the unused logits to XLA's
    dead-code elimination (serving_continuous.py:56-58)."""
    return _decoder_layers(params, cfg, tokens, pos_offset, kv_cache,
                           cross_kv)[0]


def _decoder_layers(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                    pos_offset: int, kv_cache: dict[str, torch.Tensor],
                    cross_kv: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """decoder_forward's layers: (h (B, T, d), the cache)."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, T = tokens.shape
    h = tok_embed(dec, tokens, dtype) + \
        dec["pos_emb"][pos_offset:pos_offset + T].to(dtype)
    kv_len = pos_offset + T
    tp = tp_group()
    col, row = tp_linears(tp)
    heads = local_heads(cfg, tp)
    grad = torch.is_grad_enabled() and tracks_grad(
        *tree_leaves(dec), *cross_kv.values())
    if grad and "k_s" in kv_cache:
        raise ValueError("decoder_forward: no gradient through an int8 self "
                         "cache")
    entries = []
    for i in range(cfg.n_text_layers):
        lp = layer_index(dec["layers"], i)
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k_new, v_new = qkv_fused(y, lp["attn"], heads, col)
        if grad:
            entry = {name: kv_cache[name][i].slice_scatter(
                new.to(kv_cache[name].dtype), dim=2, start=pos_offset,
                end=kv_len) for name, new in (("k", k_new), ("v", v_new))}
            entries.append(entry)
        else:
            for name, new in (("k", k_new), ("v", v_new)):
                rows = (i, slice(None), slice(None), slice(pos_offset, kv_len))
                if name + "_s" in kv_cache:
                    kv_cache[name][rows], kv_cache[name + "_s"][rows] = \
                        quantize_kv(new)
                else:
                    kv_cache[name][rows] = new
            entry = layer_index(kv_cache, i)
        a = _cache_attention(q, entry, kv_len, causal=True,
                             q_offset=pos_offset, cfg=cfg, dtype=dtype)
        h = h + row(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(col(y, lp["cross_attn"]["q"]), heads)
        a = _cache_attention(q, layer_index(cross_kv, i), None,
                             causal=False, q_offset=0, cfg=cfg, dtype=dtype)
        h = h + row(merge_heads(a), lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + row(gelu(col(y, lp["fc1"])), lp["fc2"])
    if grad:
        kv_cache = {name: torch.stack([e[name] for e in entries])
                    for name in ("k", "v")}
    return h, kv_cache


def _scores(q: torch.Tensor, k: torch.Tensor, D: int, fp32_mode: bool
            ) -> torch.Tensor:
    """(B,1,H,D) x (B,H,S,D) -> (B,H,1,S) fp32 scores. fp32 mode scales q
    before the product (mha_reference's policy); bf16 mode scales the
    fp32-accumulated product, as the JAX step does (:967-984)."""
    if fp32_mode:
        return torch.einsum("bthd,bhsd->bhts", q.float() * (D ** -0.5),
                            k.float())
    return torch.einsum("bthd,bhsd->bhts", q.float(), k.float()) * (D ** -0.5)


def _weighted(p: torch.Tensor, v: torch.Tensor, dtype, fp32_mode: bool
              ) -> torch.Tensor:
    """(B,H,1,S) x (B,H,S,D) -> (B,1,H,D) fp32; bf16 mode feeds p to the
    product in bf16 with fp32 accumulation."""
    if not fp32_mode:
        p = p.to(dtype)
    return torch.einsum("bhts,bhsd->bthd", p.float(), v.float())


def _self_attention_extra(q, k_cache, v_cache, k_new, v_new,
                          pos: int | torch.Tensor, D: int, dtype
                          ) -> torch.Tensor:
    """T==1 self-attention over a READ-ONLY cache plus the current token
    (:939): softmax over [cache rows < pos] and {self}, computed as a
    two-part softmax with a shared max and summed denominators. Identical
    products to appending k_new/v_new at row pos first.

    q: (B,1,H,D); k_cache/v_cache: (B,H,S,D); k_new/v_new: (B,H,1,D);
    pos: an int shared by every row (decoder_step_ip) or a (B,) tensor of
    per-row positions (decoder_step_ragged), which masks row b's cache at
    `< pos[b]` (:1401-1402). Returns (B,1,H,D) in dtype."""
    fp32_mode = dtype == torch.float32
    S = k_cache.shape[2]
    s_c = _scores(q, k_cache, D, fp32_mode)                   # (B,H,1,S)
    s_s = _scores(q, k_new, D, fp32_mode)                     # (B,H,1,1)
    strict = torch.arange(S, device=q.device) < (
        pos[:, None, None, None] if isinstance(pos, torch.Tensor) else pos)
    s_c = s_c.masked_fill(~strict, torch.finfo(torch.float32).min)
    m = torch.maximum(s_c.amax(dim=-1, keepdim=True), s_s)
    e_c = torch.exp(s_c - m)
    e_s = torch.exp(s_s - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s
    o = _weighted(e_c / denom, v_cache, dtype, fp32_mode)
    o = o + (e_s / denom).permute(0, 3, 1, 2) * v_new.permute(0, 2, 1, 3).float()
    return o.to(dtype)


def _cross_attention(q, k, v, D: int, dtype) -> torch.Tensor:
    """T==1 cross-attention over all n_audio_ctx positions (:1254-1298,
    the einsum form XLA runs at this size)."""
    fp32_mode = dtype == torch.float32
    p = torch.softmax(_scores(q, k, D, fp32_mode), dim=-1)
    return _weighted(p, v, dtype, fp32_mode).to(dtype)


def _scale_row(s: torch.Tensor) -> torch.Tensor:
    """Per-vector scales (B, H, S, 1) -> (B, H, 1, S), the score axis."""
    return s[..., 0].unsqueeze(2)


def _self_attention_extra_q8(q, k8, k_s, v8, v_s, k_new, v_new,
                             pos: int | torch.Tensor, D: int, dtype
                             ) -> torch.Tensor:
    """`_self_attention_extra` over a scale-commuted int8 self cache
    (:1010, the T==1 form; bf16 serving mode): the key scales multiply the
    scores and the value scales the probabilities, so no dequantized
    cache exists:
        score[s] = (q . k8[s]) * (k_s[s] * D^-0.5)
        out      = sum_s bf16(p[s] * v_s[s]) * v8[s]
    with bf16 x int8 products exact in fp32 and fp32 sums. The current
    token's k_new/v_new join unquantized. k8/v8 int8 (B,H,S,D); k_s/v_s
    fp32 (B,H,S,1); q (B,1,H,D); pos as in `_self_attention_extra` (an int,
    or (B,) per-row positions masking row b at `< pos[b]`); returns
    (B,1,H,D) in dtype."""
    s_c = torch.einsum("bthd,bhsd->bhts", q.float(), k8.float()) * (
        _scale_row(k_s) * (D ** -0.5))
    s_s = _scores(q, k_new, D, False)                          # (B,H,1,1)
    strict = torch.arange(k8.shape[2], device=q.device) < (
        pos[:, None, None, None] if isinstance(pos, torch.Tensor) else pos)
    s_c = s_c.masked_fill(~strict, torch.finfo(torch.float32).min)
    m = torch.maximum(s_c.amax(dim=-1, keepdim=True), s_s)
    e_c = torch.exp(s_c - m)
    e_s = torch.exp(s_s - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s
    pv = (e_c / denom * _scale_row(v_s)).to(dtype)
    o = torch.einsum("bhts,bhsd->bthd", pv.float(), v8.float())
    o = o + (e_s / denom).permute(0, 3, 1, 2) * v_new.permute(0, 2, 1, 3).float()
    return o.to(dtype)


def _att_cross_q8(q: torch.Tensor, cross_l: dict[str, torch.Tensor], D: int,
                  dtype) -> torch.Tensor:
    """Scale-commuted int8 cross attention for the T==1 step (:1104, the
    T==1 form; bf16 serving mode): as `_self_attention_extra_q8`, over
    all n_audio_ctx positions with a plain softmax. The JAX query tiling
    (`_mxu_query_tile`) is a TPU lowering trick that gives the same rows,
    and is not ported."""
    s = torch.einsum("bthd,bhsd->bhts", q.float(), cross_l["k"].float()) * (
        _scale_row(cross_l["k_s"]) * (D ** -0.5))
    pv = (torch.softmax(s, dim=-1) * _scale_row(cross_l["v_s"])).to(dtype)
    return torch.einsum("bhts,bhsd->bthd", pv.float(),
                        cross_l["v"].float()).to(dtype)


def _ip_cross_block() -> Optional[int]:
    """block_b of decoder_step_ip's bf16 cross read through
    decode_attention_bg: N for WHISPER_TPU_IP_CROSS=bgN, 8 for "bg", None
    for any other value or none (the einsum read), parsed as the JAX step
    does (:1265-1268). Read at every call; JAX reads it at trace time,
    which for a fixed process is the same."""
    mode = os.environ.get("WHISPER_TPU_IP_CROSS", "xla")
    if not mode.startswith("bg"):
        return None
    return int(mode[2:]) if len(mode) > 2 else 8


def decoder_step_ip(params: Params, cfg: WhisperConfig, tokens1: torch.Tensor,
                    pos: int, kv_cache: dict[str, torch.Tensor],
                    cross_kv: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One T==1 decode step at position `pos` (:1160).

    Inside the layer loop the self cache is read-only (rows < pos) and the
    current token joins as an explicit softmax term; after the loop ONE
    cache_append_rows call writes every layer's new K/V row at `pos`, in
    place. The int8 branches, as JAX routes them (:1215-1253):
      * an int8 self cache (self_kv_quant, bf16 mode) is read through
        `_self_attention_extra_q8`; after the loop the stacked rows are
        quantized, appended by the same kernel on the int8 caches, and
        their scale rows written by indexed assignment (:1328-1351);
      * an int8 cross cache is read through `_att_cross_q8` in bf16 mode
        and through decode_attention_q8_bh in fp32 mode, dequantized into
        the einsum read under the "reference" backend (:1236-1253);
      * a bf16 unquantized cross cache is read through decode_attention_bg
        when WHISPER_TPU_IP_CROSS is bg or bgN and N divides the batch
        (`_ip_cross_block`, :1260-1276); fp32 mode never takes it.
    Returns (logits (B, 1, vocab) fp32, kv_cache)."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    fp32_mode = dtype == torch.float32
    q8_self = "k_s" in kv_cache
    if q8_self and fp32_mode:
        raise ValueError("decoder_step_ip: an int8 self cache is bf16 "
                         "serving mode only (fp32 ignores self_kv_quant)")
    D = cfg.head_dim
    h = tok_embed(dec, tokens1, dtype) + dec["pos_emb"][pos].to(dtype)
    tp = tp_group()
    col, row = tp_linears(tp)
    heads = local_heads(cfg, tp)

    reference = (cfg.attn_backend or default_backend()) == "reference"
    block_b = None if fp32_mode else _ip_cross_block()

    def att_cross(q, cross_l):
        k, v = cross_l["k"], cross_l["v"]
        if "k_s" in cross_l:
            if not fp32_mode:
                return _att_cross_q8(q, cross_l, D, dtype)
            if not reference:
                return decode_attention_q8_bh(q, k, cross_l["k_s"], v,
                                              cross_l["v_s"])
            k = (k.float() * cross_l["k_s"]).to(dtype)
            v = (v.float() * cross_l["v_s"]).to(dtype)
        elif block_b and q.shape[0] % block_b == 0:
            return decode_attention_bg(q, k, v, block_b=block_b)
        return _cross_attention(q, k, v, D, dtype)

    k_news, v_news = [], []
    for i in range(cfg.n_text_layers):
        lp = layer_index(dec["layers"], i)
        cache_l = layer_index(kv_cache, i)
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k_new, v_new = qkv_fused(y, lp["attn"], heads, col)
        if q8_self:
            a = _self_attention_extra_q8(
                q, cache_l["k"], cache_l["k_s"], cache_l["v"], cache_l["v_s"],
                k_new, v_new, pos, D, dtype)
        else:
            a = _self_attention_extra(q, cache_l["k"], cache_l["v"], k_new,
                                      v_new, pos, D, dtype)
        h = h + row(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(col(y, lp["cross_attn"]["q"]), heads)
        a = att_cross(q, layer_index(cross_kv, i))
        h = h + row(merge_heads(a), lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + row(gelu(col(y, lp["fc1"])), lp["fc2"])
        k_news.append(k_new[:, :, 0, :])
        v_news.append(v_new[:, :, 0, :])
    k_rows, v_rows = torch.stack(k_news), torch.stack(v_news)
    if q8_self:
        (k_rows, k_sc), (v_rows, v_sc) = quantize_kv(k_rows), quantize_kv(v_rows)
    cache_append_rows(kv_cache["k"], kv_cache["v"],
                      k_rows.to(kv_cache["k"].dtype),
                      v_rows.to(kv_cache["v"].dtype), pos)
    if q8_self:
        kv_cache["k_s"][:, :, :, pos] = k_sc
        kv_cache["v_s"][:, :, :, pos] = v_sc
    return final_logits(params, cfg, h), kv_cache


def decoder_step_ragged(params: Params, cfg: WhisperConfig,
                        tokens1: torch.Tensor, pos: torch.Tensor,
                        kv_cache: dict[str, torch.Tensor],
                        cross_kv: dict[str, torch.Tensor]
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One T==1 decode step where every batch row sits at its OWN
    position: the continuous-batching engine's step (:1355).

    tokens1: (B, 1) each row's last token; pos: (B,) integer tensor on the
    device, each row's position and cache write index. Per-row positional
    embedding. The self cache takes one of JAX's branches:
      * in place (an unquantized cache, or an int8 one under
        self_kv_quant in bf16 mode): self-attention over the read-only
        cache masked at `< pos[b]` plus the current token
        (`_self_attention_extra`, scale-commuted for int8 in
        `_self_attention_extra_q8`); after the layer loop ONE
        cache_append_rows_ragged call writes every layer's new K/V row b
        at pos[b], in place; on an int8 cache the rows are quantized first
        and their scale rows written beside the launch (:1484-1497);
      * capacity mode (an int8 cache under kv_cache_quant, or one without
        self_kv_quant, or fp32): each layer's new rows are quantized and
        scattered at pos[b] (:1404-1416), then read through
        `_cache_attention` (dequantized, kv_len pos + 1).
    The cross read: an int8 cache scale-commuted in bf16 (`_att_cross_q8`),
    every other through `_cache_attention` (fp32 int8: T==1 and not ragged,
    so decode_attention_q8_bh where multi_head_attention_quant routes it).
    Nothing here reads the device from the host. Returns (logits
    (B, 1, vocab) fp32, kv_cache), the cache written in place."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    fp32_mode = dtype == torch.float32
    D = cfg.head_dim
    q8_self = ("k_s" in kv_cache and cfg.self_kv_quant
               and not cfg.kv_cache_quant and not fp32_mode)
    inplace = "k_s" not in kv_cache or q8_self
    h = tok_embed(dec, tokens1, dtype) + dec["pos_emb"][pos][:, None].to(dtype)
    tp = tp_group()
    col, row = tp_linears(tp)
    heads = local_heads(cfg, tp)
    k_news, v_news = [], []
    for i in range(cfg.n_text_layers):
        lp = layer_index(dec["layers"], i)
        cache_l = layer_index(kv_cache, i)
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k_new, v_new = qkv_fused(y, lp["attn"], heads, col)
        if not inplace:
            for name, new in (("k", k_new), ("v", v_new)):
                qv, sc = quantize_kv(new[:, :, 0])
                set_rows(cache_l[name], qv, pos)
                set_rows(cache_l[name + "_s"], sc, pos)
            a = _cache_attention(q, cache_l, pos + 1, causal=False,
                                 q_offset=0, cfg=cfg, dtype=dtype)
        elif q8_self:
            a = _self_attention_extra_q8(
                q, cache_l["k"], cache_l["k_s"], cache_l["v"], cache_l["v_s"],
                k_new, v_new, pos, D, dtype)
        else:
            a = _self_attention_extra(q, cache_l["k"].to(dtype),
                                      cache_l["v"].to(dtype), k_new, v_new,
                                      pos, D, dtype)
        h = h + row(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(col(y, lp["cross_attn"]["q"]), heads)
        cross_l = layer_index(cross_kv, i)
        if "k_s" in cross_l and not fp32_mode:
            a = _att_cross_q8(q, cross_l, D, dtype)
        else:
            a = _cache_attention(q, cross_l, None, causal=False, q_offset=0,
                                 cfg=cfg, dtype=dtype)
        h = h + row(merge_heads(a), lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + row(gelu(col(y, lp["fc1"])), lp["fc2"])
        if inplace:
            k_news.append(k_new[:, :, 0, :])
            v_news.append(v_new[:, :, 0, :])
    if inplace:
        k_rows, v_rows = torch.stack(k_news), torch.stack(v_news)
        if q8_self:
            (k_rows, k_sc), (v_rows, v_sc) = (quantize_kv(k_rows),
                                              quantize_kv(v_rows))
        cache_append_rows_ragged(kv_cache["k"], kv_cache["v"],
                                 k_rows.to(kv_cache["k"].dtype),
                                 v_rows.to(kv_cache["v"].dtype), pos)
        if q8_self:
            set_rows(kv_cache["k_s"], k_sc, pos)
            set_rows(kv_cache["v_s"], v_sc, pos)
    return final_logits(params, cfg, h), kv_cache
