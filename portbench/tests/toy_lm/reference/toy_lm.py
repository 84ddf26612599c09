"""The toy model type's plain reference in fp32: the audio cut into
frames of `frame_samples`, each projected to the model's width, is a
prefix before the tokens; then causal self-attention with grouped KV
heads and rotary positions, RMSNorm, a SiLU-gated MLP, and an untied
head. It takes the weights `portbench.models.toy_lm.make` draws and the
raw audio, and nothing of a program."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(B, H, T, D) with the rotary phase of positions [0, T) (halves)."""
    t, dh = x.shape[-2:]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None]
    cos, sin = (a.float().to(x.device) for a in (ang.cos(), ang.sin()))
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def logits(w: dict, cfg: dict, audio: torch.Tensor, tokens: torch.Tensor
           ) -> torch.Tensor:
    """(B, samples) audio and (B, T) tokens -> (B, T, vocab) fp32 logits
    at the tokens' positions, after the audio prefix."""
    b, t = tokens.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    frames = audio.float().reshape(b, -1, cfg["frame_samples"])
    x = torch.cat([frames @ w["proj"]["w"].float() + w["proj"]["b"].float(),
                   w["tok_emb"].float()[tokens]], 1)
    n = x.shape[1]
    dh = x.shape[2] // h
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    for i in range(cfg["num_hidden_layers"]):
        p = {k: v[i].float() for k, v in w["layers"].items()}
        y = rms(x, p["attn_norm"], eps)
        q = rotate((y @ p["q"]).view(b, n, h, dh).transpose(1, 2),
                   cfg["rope_theta"])
        k = rotate((y @ p["k"]).view(b, n, kv, dh).transpose(1, 2),
                   cfg["rope_theta"])
        v = (y @ p["v"]).view(b, n, kv, dh).transpose(1, 2)
        q = q.reshape(b, kv, h // kv, n, dh)
        s = q @ k[:, :, None].transpose(-1, -2) / math.sqrt(dh)
        o = torch.softmax(s.masked_fill(mask, float("-inf")), -1) \
            @ v[:, :, None]
        o = o.reshape(b, h, n, dh).transpose(1, 2).reshape(b, n, h * dh)
        x = x + o @ p["o"]
        y = rms(x, p["mlp_norm"], eps)
        x = x + (F.silu(y @ p["gate"]) * (y @ p["up"])) @ p["down"]
    return (rms(x, w["norm"], eps) @ w["lm_head"].float())[:, n - t:]


@torch.inference_mode()
def served_logits(w: dict, cfg: dict, audio: np.ndarray, prompts: list,
                  served: list, policy: dict, device) -> list:
    """For each request i, the logits (len(served[i]), vocab) fp32 at the
    positions that chose each served token: one pass over prompt +
    served. The toy model has no quantized form: `policy` is empty."""
    if policy:
        raise ValueError(f"the toy model has no policy {policy}")
    out = []
    for i, (prompt, got) in enumerate(zip(prompts, served)):
        wav = torch.from_numpy(np.ascontiguousarray(audio[i:i + 1])).to(device)
        tok = torch.tensor([list(prompt) + list(got[:-1])], device=device)
        p = len(prompt)
        out.append(logits(w, cfg, wav, tok)[0, p - 1:p - 1 + len(got)])
    return out
