"""Whisper encoder and decoder as functions over the params tree
(whisper_tpu/models/whisper.py), unquantized, fp32 or bf16.

The params tree and every layout are the JAX package's: layers stacked on
a leading L axis, linear weights (in, out), q (B, T, H, D), K/V and the
caches head-major (L, B, H, S, D). Where JAX scans the layers, the port
loops over them in Python.

Differences from the JAX module, all deliberate:
  * The self cache is updated IN PLACE: decoder_forward writes the prompt
    rows into the given tensors and decoder_step_ip appends with the
    in-place kernel; both also return the cache for symmetry with JAX.
  * The decode step is always decoder_step_ip (read-only cache inside the
    layer loop, the current token as an extra softmax term, one append
    after the loop), in fp32 as in bf16. The JAX package pins it to the
    append-first step (tests/test_cache_append.py:129-199).
  * fp32 products run in full fp32 only with TF32 off on the card
    (`full_fp32`): JAX runs HIGHEST precision at every fp32 product.
  * Self-attention reads one fused (d, 3d) `qkv` linear, which
    weights.to_device builds once; JAX concatenates q/k/v under jit.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu.config import WhisperConfig
from whisper_tpu_torch.ops.attention import mha_reference
from whisper_tpu_torch.ops.cache_append import cache_append_rows
from whisper_tpu_torch.ops.encoder_layer import encoder_block_tail

Params = Any    # nested dict of torch tensors
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: WhisperConfig) -> torch.dtype:
    try:
        return _DTYPES[str(cfg.compute_dtype)]
    except KeyError:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port runs "
                         f"{sorted(_DTYPES)}") from None


@contextlib.contextmanager
def full_fp32(on: bool = True):
    """TF32 trap: cuDNN runs fp32 convolutions in TF32 by default, and TF32
    keeps ~3 decimal digits, enough to flip fp32 token parity. JAX runs
    the conv stem (:404-409), the mel matmuls and the logits at HIGHEST
    precision, so inside this block (when `on`) TF32 is off for matmuls
    and cuDNN alike. The caller's settings come back on exit."""
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if on:
        matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_index(tree, i: int):
    """Layer i of a stacked (leading-L) params subtree."""
    if isinstance(tree, dict):
        return {k: layer_index(v, i) for k, v in tree.items()}
    return tree[i]


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


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b with w stored (in, out)."""
    return x @ p["w"] + p["b"]


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


def qkv_fused(y: torch.Tensor, attn: Params, n_heads: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (d -> 3d) projection through the fused `qkv` linear that
    weights.to_device builds, then split (:89): q (B,T,H,Dh), k and v
    (B,H,T,Dh)."""
    q, k, v = linear(y, attn["qkv"]).chunk(3, dim=-1)
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


def encoder_forward(params: Params, cfg: WhisperConfig, mel: torch.Tensor
                    ) -> torch.Tensor:
    """(B, n_mels, n_frames) -> (B, n_audio_ctx, d_model) (:484).

    Per block: LN1 and the fused QKV projection in torch, then the fused
    block tail (attention, o-projection, LN2, MLP) — the CUDA kernel for
    CUDA tensors, its plain twin on the CPU. Then the final LayerNorm."""
    enc = params["encoder"]
    dtype = compute_dtype(cfg)
    x = conv_stem(enc, cfg, mel) + enc["pos_emb"].to(dtype)
    for i in range(cfg.n_audio_layers):
        lp = layer_index(enc["layers"], i)
        y = layer_norm(x, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k, v = qkv_fused(y, lp["attn"], cfg.n_heads)
        x = encoder_block_tail(
            q.contiguous(), k.contiguous(), v.contiguous(), x.contiguous(),
            lp["attn"]["o"]["w"].to(dtype), lp["fc1"]["w"].to(dtype),
            lp["fc2"]["w"].to(dtype), lp["attn"]["o"]["b"], lp["fc1"]["b"],
            lp["fc2"]["b"], lp["mlp_ln"]["g"], lp["mlp_ln"]["b"],
            eps=cfg.ln_eps)
    return layer_norm(x, enc["ln_post"]["g"], enc["ln_post"]["b"], cfg.ln_eps)


# ---------------------------------------------------------------------------
# decoder + KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: WhisperConfig, batch: int, dtype: torch.dtype,
                  s_max: int, device) -> dict[str, torch.Tensor]:
    """Zeroed self-attention cache {"k", "v"}, each (L, B, H, s_max, Dh)
    (:620). s_max right-sizes the slots to what the decode can reach
    (decode._cache_slots)."""
    shape = (cfg.n_text_layers, batch, cfg.n_heads, s_max, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params: Params, cfg: WhisperConfig,
                        enc_out: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V, once per transcription
    (:654): {"k", "v"} each (L, B, H, n_audio_ctx, Dh)."""
    layers = params["decoder"]["layers"]
    ks, vs = [], []
    for i in range(cfg.n_text_layers):
        ca = layer_index(layers["cross_attn"], i)
        ks.append(split_heads_hm(linear(enc_out, ca["k"]), cfg.n_heads))
        vs.append(split_heads_hm(linear(enc_out, ca["v"]), cfg.n_heads))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def tok_embed(dec: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return dec["tok_emb"][tokens].to(dtype)


def final_logits(params: Params, cfg: WhisperConfig, h: torch.Tensor
                 ) -> torch.Tensor:
    """Final LayerNorm + tied-embedding logits, (B, T, d) -> (B, T, vocab)
    in fp32 (:756).

    bf16-logits trap: JAX multiplies the bf16 h by the bf16 embedding
    with fp32 accumulation and an fp32 result (:784-785). A bf16
    torch.matmul would round the logits to bf16 and make argmax ties, so
    both operands are upcast: bf16 x bf16 products are exact in fp32, so
    this is the same sum with an fp32 output. In fp32 mode it is the
    HIGHEST-precision product (:772-774)."""
    dec = params["decoder"]
    h = layer_norm(h, dec["ln"]["g"], dec["ln"]["b"], cfg.ln_eps)
    return h.float() @ dec["tok_emb"].float().t()


def decoder_forward(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                    pos_offset: int, kv_cache: dict[str, torch.Tensor],
                    cross_kv: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decoder pass over T tokens at positions [pos_offset,
    pos_offset + T) (:676) — the prompt prefill. Writes the new K/V rows
    into kv_cache in place, then attends with the (kv_len, causal,
    q_offset) mask through the plain attention, as XLA does at this size.
    Returns (logits (B, T, vocab) fp32, kv_cache)."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, T = tokens.shape
    h = tok_embed(dec, tokens, dtype) + \
        dec["pos_emb"][pos_offset:pos_offset + T].to(dtype)
    kv_len = pos_offset + T
    for i in range(cfg.n_text_layers):
        lp = layer_index(dec["layers"], i)
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k_new, v_new = qkv_fused(y, lp["attn"], cfg.n_heads)
        kv_cache["k"][i, :, :, pos_offset:kv_len] = k_new
        kv_cache["v"][i, :, :, pos_offset:kv_len] = v_new
        a = mha_reference(q, kv_cache["k"][i].to(dtype),
                          kv_cache["v"][i].to(dtype), kv_len,
                          causal=True, q_offset=pos_offset)
        h = h + linear(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(linear(y, lp["cross_attn"]["q"]), cfg.n_heads)
        a = mha_reference(q, cross_kv["k"][i].to(dtype),
                          cross_kv["v"][i].to(dtype))
        h = h + linear(merge_heads(a), lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + linear(gelu(linear(y, lp["fc1"])), lp["fc2"])
    return final_logits(params, cfg, h), kv_cache


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


def _self_attention_extra(q, k_cache, v_cache, k_new, v_new, pos: int,
                          D: int, dtype) -> torch.Tensor:
    """T==1 self-attention over a READ-ONLY cache plus the current token
    (:939): softmax over [cache rows < pos] and {self}, computed as a
    two-part softmax with a shared max and summed denominators. Identical
    products to appending k_new/v_new at row pos first.

    q: (B,1,H,D); k_cache/v_cache: (B,H,S,D); k_new/v_new: (B,H,1,D).
    Returns (B,1,H,D) in dtype."""
    fp32_mode = dtype == torch.float32
    S = k_cache.shape[2]
    s_c = _scores(q, k_cache, D, fp32_mode)                   # (B,H,1,S)
    s_s = _scores(q, k_new, D, fp32_mode)                     # (B,H,1,1)
    strict = torch.arange(S, device=q.device) < pos
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


def decoder_step_ip(params: Params, cfg: WhisperConfig, tokens1: torch.Tensor,
                    pos: int, kv_cache: dict[str, torch.Tensor],
                    cross_kv: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One T==1 decode step at position `pos` (:1160, unquantized).

    Inside the layer loop the self cache is read-only (rows < pos) and the
    current token joins as an explicit softmax term; after the loop ONE
    cache_append_rows call writes every layer's new K/V row at `pos`, in
    place. Returns (logits (B, 1, vocab) fp32, kv_cache)."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    D = cfg.head_dim
    h = tok_embed(dec, tokens1, dtype) + dec["pos_emb"][pos].to(dtype)
    k_news, v_news = [], []
    for i in range(cfg.n_text_layers):
        lp = layer_index(dec["layers"], i)
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k_new, v_new = qkv_fused(y, lp["attn"], cfg.n_heads)
        a = _self_attention_extra(q, kv_cache["k"][i], kv_cache["v"][i],
                                  k_new, v_new, pos, D, dtype)
        h = h + linear(merge_heads(a), lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(linear(y, lp["cross_attn"]["q"]), cfg.n_heads)
        a = _cross_attention(q, cross_kv["k"][i], cross_kv["v"][i], D, dtype)
        h = h + linear(merge_heads(a), lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + linear(gelu(linear(y, lp["fc1"])), lp["fc2"])
        k_news.append(k_new[:, :, 0, :])
        v_news.append(v_new[:, :, 0, :])
    cache_append_rows(kv_cache["k"], kv_cache["v"],
                      torch.stack(k_news).to(kv_cache["k"].dtype),
                      torch.stack(v_news).to(kv_cache["v"].dtype), pos)
    return final_logits(params, cfg, h), kv_cache
