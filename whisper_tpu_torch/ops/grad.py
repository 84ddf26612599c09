"""Gradients through the kernels, for the teacher-forced train step
(whisper_tpu/train.py differentiates the model's XLA graph with jax.grad;
the JAX package has no backward kernel, so there is none to port).

Under autograd (grad mode on and an input that requires grad) a kernel
wrapper of the train path, `encoder_block_tail` and `flash_attention`,
runs inside `kernel_with_backward` on the card: the forward launches the
forward kernel, which also keeps what the backward reads (the attention
rows' log-sum-exp), and the backward launches that wrapper's backward
kernel (`encoder_block_tail_backward`, `flash_attention_backward`). Both
are fp32 only, the train path's dtype: a bf16 call under autograd raises.
There is no fallback: a failed build or launch raises. CPU tensors never
come here: the wrappers run their plain version there, and autograd
differentiates it.

Every other kernel wrapper (the tail's int8 form, the decode reads, the
fused decoder step, the cache appends) has no backward: `refuse_grad`
makes it raise under autograd, so no output without a graph can reach a
loss.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable


def tracks_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors: grad mode on
    and at least one of them requires grad (None entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """RuntimeError when `what`, a kernel wrapper with no backward, is
    called under autograd."""
    if tracks_grad(*tensors):
        raise RuntimeError(
            f"{what}: no backward; under autograd only encoder_block_tail "
            f"and flash_attention carry a gradient (fp32). Call it under "
            f"torch.no_grad() or torch.inference_mode()")


def refuse_bf16_grad(what: str, dtype: torch.dtype) -> None:
    """RuntimeError when `what` is called under autograd in another dtype
    than fp32: its backward kernel is fp32 only, as the train path is."""
    if dtype != torch.float32:
        raise RuntimeError(
            f"{what}: no backward for {dtype}; the backward kernel is fp32 "
            f"only (training runs in float32). Call it under "
            f"torch.no_grad() or torch.inference_mode()")


class _KernelBackward(torch.autograd.Function):
    """forward: `forward(*tensors)` gives (output, residuals); backward:
    `backward(grad_out, tensors, residuals)` gives one gradient per
    tensor."""

    @staticmethod
    def forward(ctx, forward, backward, *tensors):
        out, residuals = forward(*tensors)
        ctx.backward = backward
        ctx.n_inputs = len(tensors)
        ctx.save_for_backward(*tensors, *residuals)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        n = ctx.n_inputs
        grads = ctx.backward(grad_out, saved[:n], saved[n:])
        return (None, None, *(g if need else None for g, need in
                              zip(grads, ctx.needs_input_grad[2:])))


def kernel_with_backward(forward: Callable, backward: Callable,
                         *tensors: torch.Tensor) -> torch.Tensor:
    """A differentiable call of two kernels. `forward(*tensors)` returns
    (output, residuals), the residuals a tuple of tensors that the
    backward reads besides the inputs; `backward(grad_out, tensors,
    residuals)` returns one gradient per input (the ones not needed are
    dropped). Both take the tensors positionally; bind every other
    argument beforehand (functools.partial)."""
    return _KernelBackward.apply(forward, backward, *tensors)
