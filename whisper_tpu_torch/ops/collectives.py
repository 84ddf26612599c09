"""The collectives of the port's meshes (parallel/), written out where the
JAX package lets GSPMD insert them (whisper_tpu/parallel/: shardings are
annotated and XLA places the psums and all-gathers; the port has no
partitioner). They sit below the model, which calls them inside a
`models.whisper.sharded` block.

Every helper takes a tensor and a process group, a mesh axis's
(`mesh.get_group("tp")`), and picks its transport:
  * "cpu": a CPU tensor, as it is (gloo);
  * "cuda": a CUDA tensor, as it is (NCCL; gloo for the collectives in
    GLOO_CUDA_OPS, which chip_smoke.py's mesh phase tries on the card:
    all_reduce, broadcast and all_gather run there on the H100's torch);
  * "host": a CUDA tensor on a gloo group for a collective outside
    GLOO_CUDA_OPS (point-to-point: gloo's send and recv hand the tensor's
    pointer to its host transport): copied to the host, run there, copied
    back. Several processes sharing one card run on gloo, since NCCL
    refuses two ranks on one device.
`TRANSPORTS` counts the calls by (collective, transport). `TIMEOUT` is
the one collective timeout of the port's process groups: the launcher's
and multihost.initialize's worlds and make_mesh's axis groups take it, so
that a rank stuck in a collective raises instead of waiting forever.

Under autograd the model's hooks use the differentiable forms, which are
Megatron's pair of conjugate operators and the all-gathers:
  * `reduce_from` (all_reduce forward, identity backward): the sum of a
    row-parallel product's partial sums, whose consumer is replicated;
  * `copy_to` (identity forward, all_reduce backward): the replicated
    input of a column-parallel product, whose gradient is the sum of
    every rank's partial gradient;
  * `gather_from(x, dim)` (all_gather forward, this rank's slice of the
    gradient backward): shards gathered for a replicated consumer (the
    vocab-parallel logits, the sequence-parallel encoder output);
  * `gather_partial(x, dim)` (all_gather forward, the slice of the summed
    gradient backward, a reduce-scatter): shards gathered for a consumer
    that is itself partitioned (sp's keys and values, read by each rank's
    own queries).
Outside autograd each is its plain collective.
"""

from __future__ import annotations

import collections
import datetime
from typing import Optional

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})
TRANSPORTS: collections.Counter = collections.Counter()
TIMEOUT = datetime.timedelta(seconds=300)


def size(group) -> int:
    """Ranks in `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def transport(op: str, x: torch.Tensor, group) -> str:
    """The transport of collective `op` on `x` over `group`."""
    if x.device.type == "cpu":
        return "cpu"
    if dist.get_backend(group) == "gloo" and op not in GLOO_CUDA_OPS:
        return "host"
    return "cuda"


def _staged(op: str, x: torch.Tensor, group, copy: bool
            ) -> tuple[torch.Tensor, str]:
    """x as the collective takes it, contiguous, and the transport,
    counted: a copy on the host for the "host" transport, else x or, when
    `copy`, a copy of its own (a collective that writes its buffer, on a
    tensor that must stay as it is)."""
    how = transport(op, x, group)
    TRANSPORTS[op, how] += 1
    if how == "host":
        return x.contiguous().cpu(), how
    if copy:
        return x.clone(memory_format=torch.contiguous_format), how
    return x.contiguous(), how


def all_reduce(x: torch.Tensor, group, inplace: bool = False
               ) -> torch.Tensor:
    """The sum of x over `group`, on x's device: a new tensor, or with
    `inplace` x itself, summed (a fresh partial product or a gradient
    that nothing else reads)."""
    if size(group) == 1:
        return x
    y, how = _staged("all_reduce", x, group, copy=not inplace)
    dist.all_reduce(y, group=group)
    if not inplace:
        return y.to(x.device) if how == "host" else y
    if y is not x:
        x.copy_(y)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order."""
    n = size(group)
    if n == 1:
        return x
    y, how = _staged("all_gather", x, group, copy=False)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if how == "host" else out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x from group rank `src` on every rank (a new tensor)."""
    if size(group) == 1:
        return x
    y, how = _staged("broadcast", x, group, copy=True)
    dist.broadcast(y, group_src=src, group=group)
    return y.to(x.device) if how == "host" else y


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send x to group rank `dst` (blocking)."""
    y, _ = _staged("send", x, group, copy=False)
    dist.send(y, group_dst=dst, group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped as `like`, received from group rank `src`."""
    how = transport("recv", like, group)
    TRANSPORTS["recv", how] += 1
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if how == "host" else like.device)
    dist.recv(buf, group_src=src, group=group)
    return buf.to(like.device) if how == "host" else buf


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal chunk of x along `dim`."""
    return x.chunk(size(group), dim=dim)[rank(group)].contiguous()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(g, ctx.group)
        return _slice(g, ctx.group, ctx.dim), None, None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from(x: torch.Tensor, group: Optional[dist.ProcessGroup]
                ) -> torch.Tensor:
    """all_reduce forward; the gradient passes through unchanged. x is a
    fresh partial product: outside autograd it is summed in place."""
    if size(group) == 1:
        return x
    if _grad(x):
        return _ReduceFrom.apply(x, group)
    return all_reduce(x, group, inplace=True)


def copy_to(x: torch.Tensor, group: Optional[dist.ProcessGroup]
            ) -> torch.Tensor:
    """Identity forward; the gradient is summed over `group`."""
    if size(group) == 1 or not _grad(x):
        return x
    return _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                dim: int) -> torch.Tensor:
    """all_gather along `dim` for a replicated consumer; the gradient is
    this rank's slice."""
    if size(group) == 1:
        return x
    if _grad(x):
        return _GatherFrom.apply(x, group, dim, False)
    return all_gather(x, group, dim)


def gather_partial(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int) -> torch.Tensor:
    """all_gather along `dim` for a partitioned consumer; the gradient is
    this rank's slice of the gradient summed over `group`."""
    if size(group) == 1:
        return x
    if _grad(x):
        return _GatherFrom.apply(x, group, dim, True)
    return all_gather(x, group, dim)
