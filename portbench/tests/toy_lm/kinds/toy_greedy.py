"""A closed loop of batches through a toy program: each batch is `batch`
rows of audio with the mix's prompt, decoded greedily for `max_new`
tokens by the program's own forward (its own code, not the reference's:
all heads' keys and values repeated, in the cell's `compute_dtype`), the
whole sequence again at every step. The cell's `alter` is added to every
token the program picks, as it is picked (0: none), which a test sets to
break the timed path."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench import harness, weights


def forward(w: dict, cfg: dict, audio: torch.Tensor, tokens: torch.Tensor,
            dt: torch.dtype) -> torch.Tensor:
    """(B, vocab) logits of the last position, computed in `dt`."""
    b = tokens.shape[0]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]

    def norm(x, g):
        x = x.float()
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
                * g.float()).to(dt)

    def rope(x):
        n, dh = x.shape[-2:]
        inv = 1.0 / cfg["rope_theta"] ** (
            torch.arange(0, dh, 2, dtype=torch.float64) / dh)
        ang = torch.outer(torch.arange(n, dtype=torch.float64), inv)
        cos = torch.cat([ang.cos()] * 2, -1).to(x.device, dt)
        sin = torch.cat([ang.sin()] * 2, -1).to(x.device, dt)
        half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1)
        return x * cos + half * sin

    lw = {k: v.to(dt) for k, v in w["layers"].items()}
    frames = audio.reshape(b, -1, cfg["frame_samples"]).to(dt)
    x = torch.cat([F.linear(frames, w["proj"]["w"].to(dt).t(),
                            w["proj"]["b"].to(dt)),
                   w["tok_emb"].to(dt)[tokens]], 1)
    n, d = x.shape[1:]
    dh = d // h
    for i in range(cfg["num_hidden_layers"]):
        y = norm(x, w["layers"]["attn_norm"][i])
        q = rope((y @ lw["q"][i]).view(b, n, h, dh).transpose(1, 2))
        k = rope((y @ lw["k"][i]).view(b, n, kv, dh).transpose(1, 2))
        v = (y @ lw["v"][i]).view(b, n, kv, dh).transpose(1, 2)
        k, v = (t.repeat_interleave(h // kv, 1) for t in (k, v))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + o.transpose(1, 2).reshape(b, n, d) @ lw["o"][i]
        y = norm(x, w["layers"]["mlp_norm"][i])
        x = x + (F.silu(y @ lw["gate"][i]) * (y @ lw["up"][i])) @ lw["down"][i]
    return (norm(x[:, -1], w["norm"]) @ w["lm_head"].to(dt)).float()


class Program:
    def __init__(self, ctx):
        cell, cfg, tr = ctx.cell, ctx.config, ctx.traffic
        self.w = harness.model_of(ctx).make(cfg, ctx.seed, ctx.device,
                                            getattr(torch, cell["dtype"]))
        self.cfg, self.dt = cfg, getattr(torch, cell["compute_dtype"])
        self.alter, self.max_new = cell["alter"], tr["max_new"]
        self.prompt = list(tr["prompt"])
        self.banned = [cfg["eos_token_id"]]
        samples = int(tr["audio_s"] * cfg["sampling_rate"])
        b = cell["batch"]
        self.pool = weights.audio_pool(tr["pool_batches"] * b, samples,
                                       cfg["sampling_rate"], ctx.seed,
                                       ctx.device).reshape(-1, b, samples)
        self.device = ctx.device
        self.batch(self.pool[0])

    @torch.inference_mode()
    def batch(self, audio: np.ndarray) -> np.ndarray:
        wav = torch.from_numpy(audio).to(self.device)
        tok = torch.tensor([self.prompt] * len(audio), device=self.device)
        for _ in range(self.max_new):
            lg = forward(self.w, self.cfg, wav, tok, self.dt)
            lg[:, self.banned] = float("-inf")
            nxt = (lg.argmax(-1) + self.alter) % self.cfg["vocab_size"]
            tok = torch.cat([tok, nxt[:, None]], 1)
        return tok.cpu().numpy()


def setup(ctx) -> Program:
    return Program(ctx)


def teardown(prog: Program) -> None:
    prog.w = None


def window(ctx, prog: Program) -> dict:
    """Whole batches until the first that finishes after `seconds`."""
    batches = []
    t0 = time.perf_counter()
    while True:
        k = len(batches) % len(prog.pool)
        batches.append({"pool": k, "tokens": prog.batch(prog.pool[k])})
        t_end = time.perf_counter()
        if t_end - t0 >= ctx.seconds:
            break
    b = ctx.cell["batch"]
    return {"kind": "closed_loop", "attempted": b * len(batches),
            "failed": 0, "batches": batches, "t0": t0, "t_end": t_end,
            "audio_s": len(batches) * b * ctx.traffic["audio_s"], "rows": b}


def sample(ctx, prog: Program, obs: dict) -> dict:
    """`sample.rows` rows of the window's batches, drawn from the seed."""
    rng = np.random.default_rng(weights.subseed(ctx.seed, "sample"))
    every = len(obs["batches"]) * obs["rows"]
    pick = rng.permutation(every)[:min(ctx.cell["sample"]["rows"], every)]
    p = len(prog.prompt)
    audio, served = [], []
    for j in sorted(pick.tolist()):
        bt, row = obs["batches"][j // obs["rows"]], j % obs["rows"]
        audio.append(prog.pool[bt["pool"]][row])
        served.append(bt["tokens"][row, p:].tolist())
    return {"audio": np.stack(audio), "prompts": [prog.prompt] * len(served),
            "served": served, "banned_ids": prog.banned, "banned_from": None}
