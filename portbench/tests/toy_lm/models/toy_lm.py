"""The toy model type (`toy_lm`): its weights drawn from the seed in one
call, its reference in `portbench.reference.toy_lm`, and no preset of the
port to share sizes with."""

from __future__ import annotations

import math

import torch

from portbench import weights
from portbench.reference import toy_lm

served_logits = toy_lm.served_logits


def shapes(cfg: dict) -> dict:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    n = cfg["num_hidden_layers"]
    dh = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * dh
    return {"proj": {"w": (cfg["frame_samples"], d), "b": (d,)},
            "tok_emb": (cfg["vocab_size"], d),
            "layers": {"attn_norm": (n, d), "q": (n, d, d), "k": (n, d, kv),
                       "v": (n, d, kv), "o": (n, d, d), "mlp_norm": (n, d),
                       "gate": (n, d, ff), "up": (n, d, ff),
                       "down": (n, ff, d)},
            "norm": (d,), "lm_head": (d, cfg["vocab_size"])}


def make(cfg: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """Norm gains ones and the bias zeros, in fp32; every matrix normal
    over the square root of its input width (the token table normal), in
    `dtype`, from one draw."""
    flat = list(weights.leaves(shapes(cfg)))
    drawn = [(p, s) for p, s in flat if len(s) >= 2 and "norm" not in p]
    g = torch.Generator(device=device).manual_seed(
        weights.subseed(seed, "weights"))
    buf = torch.randn(sum(math.prod(s) for _, s in drawn), generator=g,
                      device=device, dtype=dtype)
    views, at = {}, 0
    for p, s in drawn:
        views[p] = buf[at:at + math.prod(s)].view(s)
        if p != "tok_emb":
            views[p].mul_(1.0 / math.sqrt(s[-2]))
        at += math.prod(s)
    out: dict = {}
    for p, s in flat:
        leaf = views.get(p)
        if leaf is None:
            leaf = torch.full(s, 0.0 if p.endswith("/b") else 1.0,
                              device=device)
        node = out
        *keys, last = p.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def preset_pairs(ctx) -> list:
    """No preset of the port: nothing to share."""
    return []
