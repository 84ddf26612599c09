"""Weights and audio made from the run's seed, on the device, in a few
large calls.

The tree has the layout the port's loaders give (`whisper_tpu_torch.
weights.param_shapes`, rebuilt here from the configuration file so that
the reference needs nothing of the program): transformer layers stacked
on a leading axis, linear weights stored (in, out), conv weights (out,
in, k). Leaves: "g" ones, "b" zeros, the encoder's positions sinusoidal,
the conv stem's weights normal x 1 / sqrt(fan in), the query and key
weights of every attention normal x sqrt(4 / d), every other leaf normal
x 0.02 (the scale of the port's `init_params`).

The two exceptions make the served tokens depend on the audio and on the
position, so that a check of them sees the encoder, the cross reads and
the self cache. At 0.02 everywhere the stem's features are a twentieth
of the positions' (the encoder sees the positions, not the audio), and
every attention is nearly flat (score deviation 0.02^2 d: 0.4 at d =
1024, so cross attention averages the frames away): every row, whatever
its audio, served the same token at every position (tiny's width on the
CPU, 4 rows x 8 tokens, all one id). With them, scores have deviation 4
on the unit-variance LayerNorm outputs, and rows of different audio
share 0-6% of their tokens. The shapes, and so the work, are the same.

The normal leaves come from ONE draw of a `torch.Generator` on the
device, in bf16 where the model is served in bf16, cut into views and
scaled in place; the same seed gives the same values, so the reference
makes its own copy by calling `make` again after the program is gone.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from portbench.costs import dims

QK_SCORE_STD = 4.0


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def shapes(cfg: dict) -> dict:
    """The params tree of `cfg` with each leaf's shape in place."""
    d, ff, la, lt, mels, vocab, frames = dims(cfg)

    def lin(n: int, d_in: int, d_out: int) -> dict:
        return {"w": (n, d_in, d_out), "b": (n, d_out)}

    def ln(*lead: int) -> dict:
        return {"g": (*lead, d), "b": (*lead, d)}

    def layer(n: int, cross: bool) -> dict:
        p = {"attn": {k: lin(n, d, d) for k in "qkvo"}, "attn_ln": ln(n),
             "fc1": lin(n, d, ff), "fc2": lin(n, ff, d), "mlp_ln": ln(n)}
        if cross:
            p["cross_attn"] = {k: lin(n, d, d) for k in "qkvo"}
            p["cross_ln"] = ln(n)
        return p

    return {
        "encoder": {"conv1": {"w": (d, mels, 3), "b": (d,)},
                    "conv2": {"w": (d, d, 3), "b": (d,)},
                    "pos_emb": (frames, d),
                    "layers": layer(la, False), "ln_post": ln()},
        "decoder": {"tok_emb": (vocab, d),
                    "pos_emb": (cfg["max_target_positions"], d),
                    "layers": layer(lt, True), "ln": ln()},
    }


def leaves(tree, path: str = ""):
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder positions, fp32 (openai/whisper `sinusoids`)."""
    log_timescale = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
    return torch.cat([scaled.sin(), scaled.cos()], 1).float()


def make(cfg: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The params tree on `device`: leaves of rank >= 2 in `dtype` (the
    type they are served in), the 1-D ones in fp32, as the port keeps
    them."""
    tree = shapes(cfg)
    flat = list(leaves(tree))
    normal = [(p, s) for p, s in flat
              if p.rsplit("/", 1)[-1] not in ("g", "b")
              and p != "encoder/pos_emb"]
    total = sum(math.prod(s) for _, s in normal)
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    buf = torch.randn(total, generator=g, device=device, dtype=dtype)
    qk = math.sqrt(QK_SCORE_STD / cfg["d_model"])
    out: dict = {}
    at = 0
    views = {}
    for p, s in normal:
        n = math.prod(s)
        views[p] = buf[at:at + n].view(s)
        if p.startswith("encoder/conv"):
            views[p].mul_(1.0 / math.sqrt(s[1] * s[2]))
        else:
            views[p].mul_(qk if p.endswith(("attn/q/w", "attn/k/w"))
                          else 0.02)
        at += n
    for p, s in flat:
        kind = p.rsplit("/", 1)[-1]
        dt = dtype if len(s) >= 2 else torch.float32
        if p in views:
            leaf = views[p]
        elif p == "encoder/pos_emb":
            leaf = sinusoids(*s).to(device=device, dtype=dt)
        else:
            leaf = torch.full(s, 1.0 if kind == "g" else 0.0, dtype=dt,
                              device=device)
        node = out
        keys = p.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def audio_pool(n: int, samples: int, sample_rate: int, seed: int,
               device) -> np.ndarray:
    """`n` clips of `samples` fp32 samples: noise at 0.05 and three sines
    of 100-4000 Hz at amplitudes 0.05-0.3, drawn on `device` and brought
    to the host (the program takes host audio, as from a file)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "audio"))
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    freq = 100.0 + 3900.0 * torch.rand(n, 3, 1, generator=g, device=device)
    amp = 0.05 + 0.25 * torch.rand(n, 3, 1, generator=g, device=device)
    phase = 2 * math.pi * torch.rand(n, 3, 1, generator=g, device=device)
    x = 0.05 * torch.randn(n, samples, generator=g, device=device)
    x += (amp * torch.sin(2 * math.pi * freq * t + phase)).sum(1)
    return x.cpu().numpy()
