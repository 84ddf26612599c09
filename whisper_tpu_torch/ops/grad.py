"""Gradients through the kernels, for the teacher-forced train step
(whisper_tpu/train.py differentiates the model's XLA graph with jax.grad;
the JAX package has no backward kernel, so there is none to port).

Under autograd (grad mode on and an input that requires grad) a kernel
wrapper of the train path, `encoder_block_tail` and `flash_attention`,
launches its forward kernel inside `kernel_with_plain_backward`: the
forward is the kernel's output, and the backward recomputes the plain
twin on the saved inputs and differentiates it. The twin rounds where the
kernel rounds, so its gradient is the gradient of the kernel's function.
This is no fallback: on the card the forward always launches the kernel,
and a failed build or launch raises. The backward runs no kernel of this
package.

Every other kernel wrapper (the tail's int8 form, the decode reads, the
fused decoder step, the cache appends) has no backward: `refuse_grad`
makes it raise under autograd, so no output without a graph can reach a
loss.
"""

from __future__ import annotations

from typing import Callable

import torch


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
            f"and flash_attention carry a gradient. Call it under "
            f"torch.no_grad() or torch.inference_mode()")


class _PlainBackward(torch.autograd.Function):
    """forward: `kernel(*tensors)`; backward: the autograd gradient of
    `plain(*tensors)` at the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(tensors, need)]
            wrt = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(ctx.plain(*inputs), wrt,
                                             grad_out, allow_unused=True))
        out = []
        for t, n in zip(inputs, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and g is None else g)
        return (None, None, *out)


def kernel_with_plain_backward(kernel: Callable, plain: Callable,
                               *tensors: torch.Tensor) -> torch.Tensor:
    """`kernel(*tensors)` as the value, `plain`'s gradient as the
    backward. Both take the tensors positionally; bind every other
    argument beforehand (functools.partial)."""
    return _PlainBackward.apply(kernel, plain, *tensors)
