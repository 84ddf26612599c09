"""Parameters for the port: conversion from the JAX params tree, the
reference flat-bin reader, seeded random init, and device placement.

The params are the JAX package's nested dict, unchanged in structure and
layout, with torch tensors at the leaves (whisper_tpu/weights.py and
whisper_tpu/models/whisper.py:309 init_params):
  * transformer layers stacked on a leading L axis;
  * linear weights stored (in, out) so every projection is `x @ w`;
  * k_proj's bias slot present and zero (HF k_proj has no bias);
  * conv weights in torch's (out, in, k) layout.
`to_device` places a tree for the model and replaces each self-attention's
q/k/v linears with one fused (d, 3d) `qkv` linear.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from whisper_tpu_torch.config import WhisperConfig

Params = Any    # nested dict of torch tensors


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree) -> Params:
    """The JAX params tree (leaves as numpy arrays, e.g. after
    `jax.tree.map(np.asarray, params)`) -> the same tree of CPU tensors:
    int8 leaves (a tree after the JAX quantize_weights_wq) stay int8,
    every other leaf becomes fp32. Leaves are copied, so the result owns
    its memory."""
    def leaf(x):
        dt = np.int8 if np.asarray(x).dtype == np.int8 else np.float32
        return torch.from_numpy(np.array(x, dtype=dt))
    return _tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# reference flat-binary reader (whisper_tpu/weights.py:156, numpy only)
# ---------------------------------------------------------------------------

def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def from_flat_bin(data, cfg: WhisperConfig) -> Params:
    """Parse the reference's headerless little-endian fp32 weight stream
    (the order IS the contract; whisper_tpu/weights.py:156 from_flat_bin)
    into a params tree of fp32 CPU tensors. `data`: bytes or an fp32
    ndarray (e.g. a memmap)."""
    buf = (np.frombuffer(data, dtype="<f4") if isinstance(data, bytes)
           else np.asarray(data).view("<f4").reshape(-1))
    pos = 0

    def take(*shape: int) -> np.ndarray:
        nonlocal pos
        n = int(np.prod(shape))
        if pos + n > buf.size:
            raise ValueError(f"flat bin exhausted: need {n} floats at offset "
                             f"{pos}, have {buf.size - pos}")
        out = np.array(buf[pos:pos + n]).reshape(shape)
        pos += n
        return out

    d, ff, nm = cfg.d_model, cfg.d_ff, cfg.n_mels

    def lin(rows: int, cols: int, bias: bool = True) -> dict:
        w = take(rows, cols)                 # (out, in)
        b = take(rows) if bias else np.zeros((rows,), np.float32)
        return {"w": np.ascontiguousarray(w.T), "b": b}

    def ln() -> dict:
        return {"g": take(d), "b": take(d)}

    def attn() -> dict:
        # write order q_w,q_b,k_w,v_w,v_b,out_w,out_b
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
                "o": lin(d, d)}

    def enc_layer() -> dict:
        a, a_ln = attn(), ln()
        fc1, fc2 = lin(ff, d), lin(d, ff)
        return {"attn": a, "attn_ln": a_ln, "fc1": fc1, "fc2": fc2,
                "mlp_ln": ln()}

    def dec_layer() -> dict:
        a, a_ln = attn(), ln()
        x, x_ln = attn(), ln()
        fc1, fc2 = lin(ff, d), lin(d, ff)
        return {"attn": a, "attn_ln": a_ln, "cross_attn": x,
                "cross_ln": x_ln, "fc1": fc1, "fc2": fc2, "mlp_ln": ln()}

    conv1 = {"w": take(d, nm, 3), "b": take(d)}
    conv2 = {"w": take(d, d, 3), "b": take(d)}
    enc_pos = take(cfg.n_audio_ctx, d)
    enc_layers = _stack([enc_layer() for _ in range(cfg.n_audio_layers)])
    enc_ln = ln()
    tok_emb = take(cfg.vocab_size, d)
    dec_pos = take(cfg.n_text_ctx, d)
    dec_layers = _stack([dec_layer() for _ in range(cfg.n_text_layers)])
    dec_ln = ln()
    if pos != buf.size:
        raise ValueError(f"flat bin has {buf.size - pos} unread floats")
    return from_jax_params({
        "encoder": {"conv1": conv1, "conv2": conv2, "pos_emb": enc_pos,
                    "layers": enc_layers, "ln_post": enc_ln},
        "decoder": {"tok_emb": tok_emb, "pos_emb": dec_pos,
                    "layers": dec_layers, "ln": dec_ln},
    })


def from_flat_bin_path(path: str, cfg: WhisperConfig) -> Params:
    """Read a flat-bin file through a read-only memmap."""
    try:
        return from_flat_bin(np.memmap(path, dtype="<f4", mode="r"), cfg)
    except ValueError as e:
        raise ValueError(
            f"{path} does not match the {cfg.name!r} layout ({e}). The "
            f"flat-bin format is positional — pass the model the file was "
            f"exported for.") from None


# ---------------------------------------------------------------------------
# seeded random init (shapes and scales of whisper_tpu init_params)
# ---------------------------------------------------------------------------

def init_params(cfg: WhisperConfig, seed: int) -> Params:
    """Random params with the exact shapes of a converted checkpoint and
    the JAX init's scales (normal * 0.02 weights, zero biases, LayerNorm
    ones/zeros, sinusoidal encoder positions), drawn from a numpy
    RandomState(seed). The draws differ from jax.random's: use
    from_jax_params to run the port on the JAX package's weights."""
    from whisper_tpu_torch.models.whisper import sinusoidal_positions

    rng = np.random.RandomState(seed)
    d, ff = cfg.d_model, cfg.d_ff

    def normal(*shape: int, scale: float = 0.02) -> np.ndarray:
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def lin(d_in: int, d_out: int) -> dict:
        return {"w": normal(d_in, d_out), "b": np.zeros((d_out,), np.float32)}

    def ln() -> dict:
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def attn() -> dict:
        return {n: lin(d, d) for n in ("q", "k", "v", "o")}

    def enc_layer() -> dict:
        return {"attn": attn(), "attn_ln": ln(), "fc1": lin(d, ff),
                "fc2": lin(ff, d), "mlp_ln": ln()}

    def dec_layer() -> dict:
        p = enc_layer()
        p["cross_attn"] = attn()
        p["cross_ln"] = ln()
        return p

    tree = {
        "encoder": {
            "conv1": {"w": normal(d, cfg.n_mels, 3),
                      "b": np.zeros((d,), np.float32)},
            "conv2": {"w": normal(d, d, 3), "b": np.zeros((d,), np.float32)},
            "pos_emb": sinusoidal_positions(cfg.n_audio_ctx, d).numpy(),
            "layers": _stack([enc_layer() for _ in range(cfg.n_audio_layers)]),
            "ln_post": ln(),
        },
        "decoder": {
            "tok_emb": normal(cfg.vocab_size, d),
            "pos_emb": normal(cfg.n_text_ctx, d),
            "layers": _stack([dec_layer() for _ in range(cfg.n_text_layers)]),
            "ln": ln(),
        },
    }
    return from_jax_params(tree)


def to_device(params: Params, device, dtype: torch.dtype | None = None
              ) -> Params:
    """Move every leaf to `device`; with `dtype`, cast the fp32 leaves of
    rank >= 2 to it — the JAX package's rule (whisper_tpu/weights.py:337
    to_device), so the stacked per-layer biases and LayerNorm params take
    the compute dtype while the top-level 1-D ones stay fp32. The leaves
    of an int8 tree keep their types: int8 values, and the fp32 scales
    (`w_s`, `tok_emb_s`), which the JAX pipeline makes after its cast.

    Each self-attention's q, k and v linears become one `qkv` linear,
    weight (L, d, 3d) and bias (L, 3d) (and an int8 linear's scales
    (L, 3d)), fused once here: the JAX model concatenates them inside its
    jitted step (models/whisper.py:89 qkv_fused), the port's eager step
    would do it at every call. A tree placed before keeps its fused
    linear."""
    device = torch.device(device)

    def put(tree, name=""):
        if isinstance(tree, dict):
            return {k: put(v, k) for k, v in tree.items()}
        if (dtype is not None and tree.dtype == torch.float32
                and tree.ndim >= 2 and not name.endswith("_s")):
            tree = tree.to(dtype)
        return tree.to(device)

    def fuse(attn: dict) -> dict:
        if "qkv" in attn:
            return attn
        qkv = {n: torch.cat([attn[p][n] for p in "qkv"], dim=-1)
               for n in attn["q"]}
        return {"qkv": qkv, "o": attn["o"]}

    params = {part: dict(sub) for part, sub in params.items()}
    for part in ("encoder", "decoder"):
        layers = dict(params[part]["layers"])
        layers["attn"] = fuse(layers["attn"])
        params[part]["layers"] = layers
    return put(params)
