"""Mesh construction and sharding rules for the Whisper family
(whisper_tpu/parallel/mesh.py), on torch.distributed.

The axes and the rule table are the JAX package's:
  * dp (data parallel): the batch of mel, tokens and caches;
  * tp (tensor parallel): Megatron-style within every block: q/k/v and
    fc1 column-sharded (heads split across ranks), the out-projections
    and fc2 row-sharded, the vocab embedding row-sharded (zero-padded to
    `padded_vocab_rows`) so that the logit product splits;
  * sp (sequence parallel): the 1500 encoder frames;
  * pp (pipeline parallel): the stacked-layer axis
    (parallel/pipeline_parallel.py).

The mesh is a `DeviceMesh` whose axis groups make_mesh creates with the
port's collective timeout (ops/collectives.TIMEOUT); on CUDA it pins
each process to its own card first (multihost.pin_device). A spec is a tuple of axis names or None per
dimension, as a PartitionSpec. There are no global arrays: `shard_params`
returns this rank's local tree (plain tensors, which the kernels take as
they are) and `shard_tensor` this rank's block of any tensor; the model
runs on them inside `models.whisper.sharded`, with the collectives
written out (ops/collectives.py).
"""

from __future__ import annotations

import datetime
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.parallel.multihost import pin_device

Params = Any
Spec = tuple


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              device_type: str = "cuda",
              timeout: datetime.timedelta = collectives.TIMEOUT
              ) -> DeviceMesh:
    """A (dp, sp, tp[, pp]) mesh over the world's processes (:36), rank r
    at the row-major position r. The pp axis exists when pp > 1, as in
    JAX. Raises ValueError when the product differs from the world size.
    With no process group and a mesh of one, opens a world of one process
    itself (NCCL for "cuda", gloo for "cpu"). On "cuda" the process is
    pinned to its card first (multihost.pin_device). Every collective on
    the mesh's groups raises after `timeout`."""
    n = dp * sp * tp * pp
    if device_type == "cuda":
        pin_device(dist.get_rank() if dist.is_initialized() else 0)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {dp}x{sp}x{tp}x{pp} needs {n} processes; start them "
                f"with parallel.launch.run, or torchrun and "
                f"multihost.initialize")
        # the degenerate mesh: one process, no launcher (multihost.py)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
    names = ("dp", "sp", "tp", "pp") if pp > 1 else ("dp", "sp", "tp")
    return axes_mesh(dict(zip(names, (dp, sp, tp, pp))), device_type,
                     timeout)


def axes_mesh(axes: dict[str, int], device_type: str = "cuda",
              timeout: datetime.timedelta = collectives.TIMEOUT
              ) -> DeviceMesh:
    """A mesh of the named axes (sizes in order, row-major over the
    world's ranks): make_mesh's, or another such as expert.py's (dp, ep).
    The world must exist and hold their product of processes; each axis
    group's collectives raise after `timeout`."""
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"mesh {axes} != {dist.get_world_size()} "
                         f"processes")
    names = tuple(axes)
    ranks = torch.arange(n).reshape(shape)
    me = dist.get_rank()
    groups = []
    for axis in range(len(names)):
        mine = None
        # every rank creates every group, in the same order
        for row in ranks.movedim(axis, -1).reshape(-1, ranks.shape[axis]):
            g = dist.new_group(row.tolist(), timeout=timeout)
            if me in row.tolist():
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                 mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of `axis` (KeyError when the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise KeyError(axis)
    return mesh.size(names.index(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank along `axis`, or None when the mesh
    has no such axis or it has one rank."""
    if axis not in (mesh.mesh_dim_names or ()) or axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(params: Params, pipeline: bool = False) -> Params:
    """The spec tree of a params tree (:57): the tp rules, and with
    pipeline=True the stacked-layer axis over pp. The same table as JAX,
    read from the same path strings."""

    def spec_for(path: str, x) -> Spec:
        nd = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
        layer_ax = ("pp" if pipeline and "layers" in path else None)
        if "_s'" in path:                       # int8 scales: replicated
            return (None,) * nd
        if "tok_emb" in path:
            return ("tp", None)                 # vocab-sharded logits
        if "pos_emb" in path:
            return (None, None)
        if "conv" in path:
            return (None,) * nd
        if nd <= 2 and ("'g'" in path or ("ln" in path and "'b'" in path)):
            if nd == 2 and layer_ax:
                return (layer_ax, None)
            return (None,) * nd
        if nd == 3:
            if "fc2" in path or "'o'" in path:
                return (layer_ax, "tp", None)   # row-parallel
            return (layer_ax, None, "tp")       # column-parallel
        if nd == 2:
            if "fc2" in path or "'o'" in path:
                return (layer_ax, None)         # row-parallel bias
            return (layer_ax, "tp")
        return (None,) * nd

    return _map_with_path(spec_for, params)


def sanitize_pspec(shape: Sequence[int], spec: Spec, mesh: DeviceMesh
                   ) -> Spec:
    """Drop sharded axes whose dimension the axis size does not divide
    (:107): the fallback for leaves that resist the rule table (the vocab
    is padded instead, see shard_params)."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([axis_size(mesh, a) for a in axes]))
        fixed.append(ax if dim % n == 0 else None)
    return tuple(fixed)


# Per-shard vocab rows are rounded up to a multiple of 128, as in JAX, so
# that a shard's shapes equal the JAX package's.
_VOCAB_LANE = 128


def padded_vocab_rows(vocab: int, tp: int) -> int:
    """Smallest row count >= vocab that splits into tp equal 128-row
    multiples (:127; 51,865 at tp=4 -> 52,224 = 4 x 102 x 128)."""
    per = -(-vocab // (tp * _VOCAB_LANE)) * _VOCAB_LANE
    return per * tp


def pad_vocab(emb: torch.Tensor, tp: int) -> torch.Tensor:
    """The token embedding zero-padded to padded_vocab_rows when tp > 1
    does not divide its rows (:174-178), else as it is."""
    if tp == 1 or emb.shape[0] % tp == 0:
        return emb
    rows = padded_vocab_rows(emb.shape[0], tp)
    return torch.cat([emb, emb.new_zeros(rows - emb.shape[0],
                                         emb.shape[1])])


def shard_tensor(x: torch.Tensor, spec: Spec, mesh: DeviceMesh
                 ) -> torch.Tensor:
    """This rank's block of x under `spec` (the local shard that
    jax.device_put(x, NamedSharding(mesh, spec)) would place here): along
    every dimension sharded over axes (a, ...), the block at this rank's
    coordinate, the axes' coordinates taken row-major. A copy: it owns its
    memory."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            s = axis_size(mesh, a)
            n, idx = n * s, idx * s + mesh.get_local_rank(a)
        if x.shape[dim] % n:
            raise ValueError(f"shard_tensor: dimension {dim} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        x = x.chunk(n, dim=dim)[idx]
    return x.clone(memory_format=torch.contiguous_format)


def shard_params(params: Params, mesh: DeviceMesh,
                 pipeline: Optional[bool] = None) -> Params:
    """This rank's local params tree per param_pspecs (:140); axes that do
    not divide are replicated (sanitize_pspec). pipeline defaults to True
    exactly when the mesh has a pp axis of more than one rank.

    The tree is the JAX package's structure with q, k and v apart (as
    init_params, the loaders and weights.from_jax_params give it); each
    rank fuses its own q/k/v shards afterwards (weights.to_device). A tree
    with fused `qkv` linears raises under tp > 1: a column split of the
    fused matrix would give rank 0 all of q.

    Vocab padding: under tp > 1 the token embedding is zero-padded to
    padded_vocab_rows() before the split; the pad rows give exact-zero
    logits, which final_logits slices off. A weight_quant tree raises
    under tp > 1, as in JAX (:164-172)."""
    if pipeline is None:
        pipeline = ("pp" in (mesh.mesh_dim_names or ())
                    and axis_size(mesh, "pp") > 1)
    tp = axis_size(mesh, "tp") if "tp" in (mesh.mesh_dim_names or ()) else 1
    if tp > 1 and "tok_emb_s" in params.get("decoder", {}):
        raise NotImplementedError(
            "weight_quant trees cannot be tensor-parallel sharded; shard "
            "the unquantized tree (weight_quant is a single-chip serving "
            "feature)")
    if tp > 1 and any("qkv" in part.get("layers", {}).get("attn", {})
                      for part in params.values()):
        raise ValueError("shard_params: the tree's q/k/v are fused (a "
                         "to_device tree); shard the tree with q, k and v "
                         "apart, then fuse each rank's shards")
    specs = param_pspecs(params, pipeline=pipeline)

    def place(path: str, x):
        spec = _lookup(specs, path)
        x = torch.as_tensor(x)
        if "tok_emb" in path and x.dim() == 2:
            x = pad_vocab(x, tp)
        return shard_tensor(x, sanitize_pspec(x.shape, spec, mesh), mesh)

    return _map_with_path(place, params)


def _lookup(tree, path: str):
    """The leaf of `tree` at a keystr path."""
    for key in path[2:-2].split("']['"):
        tree = tree[key]
    return tree


def activation_shardings(mesh: DeviceMesh) -> dict[str, Spec]:
    """The activation and IO specs (:186): batch over dp; the mel time
    axis, and so the encoder sequence, over sp when present."""
    sp = "sp" if "sp" in (mesh.mesh_dim_names or ()) else None
    return {
        "mel": ("dp", None, sp),        # (B, n_mels, T)
        "enc_out": ("dp", sp, None),    # (B, S, d)
        "tokens": ("dp", None),         # (B, T)
        "audio": ("dp", sp),            # (B, samples)
        "replicated": (),
    }
