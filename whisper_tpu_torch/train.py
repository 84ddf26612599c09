"""Fine-tuning: the teacher-forced loss and the train step
(whisper_tpu/train.py), on the card unless the parameters lie on the CPU.

The parameters are a `weights.trainable` tree (fp32, the fused `qkv`
linears, every leaf requiring grad); `weights.from_device` takes them
back to the JAX package's layout for `save_npz`. The forward is the
model's own: the encoder's tail kernel once per layer (or the tail-off
branch through the flash kernel), the decoder's T > 1 reads through the
flash kernel where the attention gate sends them. The backward of each
kernel is its plain twin's autograd gradient (ops/grad.py): the JAX
package has no backward kernel to port, jax.grad differentiates its XLA
graph. Every other kernel wrapper raises under autograd.

The optimizer is JAX's optax chain, clip_by_global_norm(1.0) then adamw
over warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1)),
on torch.optim.AdamW:
  * the clip scales by max_norm / |g| only where |g| >= max_norm, as
    (g / |g|) * max_norm (optax; torch's clip_grad_norm_ divides by
    |g| + 1e-6 and is not used);
  * the schedule counts updates from 0, so the first update has lr 0;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every leaf, LayerNorms,
    biases and positions included, by the scheduled lr, as optax's adamw.
Training is fp32 only: JAX's loss_fn raises on a bf16 compute dtype
(its scan carry changes type), so `loss_fn` raises ValueError there.
fp32 products run with TF32 off (`full_fp32`), the backward too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    decoder_forward,
    encoder_forward,
    full_fp32,
    init_kv_cache,
    precompute_cross_kv,
    tree_leaves,
)

Params = Any
MAX_GRAD_NORM = 1.0          # optax.clip_by_global_norm(1.0) (:58)


class TrainBatch(NamedTuple):
    mel: torch.Tensor        # (B, n_mels, n_frames)
    tokens: torch.Tensor     # (B, T) integer: the full sequence, SOT prompt included
    loss_mask: torch.Tensor  # (B, T) fp32: 1 where the *next* token is a target


def loss_fn(params: Params, cfg: WhisperConfig, batch: TrainBatch
            ) -> torch.Tensor:
    """Mean masked cross-entropy of next-token prediction under teacher
    forcing (:36-49): the encoder, the cross K/V, one decoder pass over
    the whole sequence on a zeroed cache of n_text_ctx slots, then the
    masked mean of -log p(tokens[t + 1]) from position t's logits in fp32.
    A 0-d fp32 tensor on the parameters' device."""
    if compute_dtype(cfg) != torch.float32:
        raise ValueError(f"loss_fn: training runs in float32 only (JAX's "
                         f"loss_fn fails under {cfg.compute_dtype!r})")
    dev = params["decoder"]["tok_emb"].device
    mel = torch.as_tensor(batch.mel, dtype=torch.float32, device=dev)
    tokens = torch.as_tensor(batch.tokens, device=dev).long()
    mask = torch.as_tensor(batch.loss_mask, dtype=torch.float32, device=dev)
    with full_fp32():
        enc_out = encoder_forward(params, cfg, mel)
        cross = precompute_cross_kv(params, cfg, enc_out)
        cache = init_kv_cache(cfg, tokens.shape[0], torch.float32,
                              cfg.n_text_ctx, dev)
        logits, _ = decoder_forward(params, cfg, tokens, 0, cache, cross)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        m = mask[:, :-1]
        return (nll * m).sum() / m.sum().clamp_min(1.0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule with end_value 0 and exponent 1:
    linear from init_value to peak_value over warmup_steps, then cosine
    decay to 0 over decay_steps - warmup_steps, held there after."""
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
    return schedule


def clip_by_global_norm(grads: list, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm(max_norm), in place: where the global
    norm |g| (optax's global_norm: the root of the sum of every value's
    square) is >= max_norm every gradient becomes (g / |g|) * max_norm,
    else it is left as it is. No host read. `norm`: |g| when the caller
    has it (a sharded step, whose grads are shards of the whole), else
    computed from `grads`. Returns |g| before the clip, a 0-d fp32
    tensor."""
    if norm is None:
        norm = torch.stack([g.float().square().sum()
                            for g in grads]).sum().sqrt()
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


@dataclasses.dataclass
class Optimizer:
    """make_optimizer's state: AdamW over the leaves, the schedule and
    the number of updates made."""
    adamw: torch.optim.AdamW
    schedule: Callable[[int], float]
    count: int = 0


def make_optimizer(params: Params, lr: float = 1e-5,
                   weight_decay: float = 0.01, warmup_steps: int = 50,
                   total_steps: int = 1000) -> Optimizer:
    """JAX's make_optimizer (:52-60) over a `trainable` tree."""
    adamw = torch.optim.AdamW(list(tree_leaves(params)), lr=0.0,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    return Optimizer(adamw, warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1)))


def train_step(params: Params, opt: Optimizer, cfg: WhisperConfig,
               batch: TrainBatch) -> dict[str, torch.Tensor]:
    """One update (:63-72), in place on the `trainable` leaves: the loss
    and its gradients, then `optimizer_step`. Returns {"loss",
    "grad_norm"} as 0-d tensors on the parameters' device, grad_norm the
    global norm before the clip."""
    opt.adamw.zero_grad(set_to_none=True)
    with full_fp32():
        loss = loss_fn(params, cfg, batch)
        loss.backward()
        norm = optimizer_step(params, opt)
    return {"loss": loss.detach(), "grad_norm": norm}


def optimizer_step(params: Params, opt: Optimizer,
                   norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax's update from the leaves' `.grad`: the clip, then AdamW at
    the scheduled lr; counts the update. A leaf with no gradient takes a
    zero one (optax decays and moves it). `norm`: the global norm when
    the leaves are shards (parallel/pipeline_parallel.train_step_pp).
    Returns the global norm before the clip."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm([p.grad for p in leaves], MAX_GRAD_NORM, norm)
    for group in opt.adamw.param_groups:
        group["lr"] = opt.schedule(opt.count)
    opt.adamw.step()
    opt.count += 1
    return norm
