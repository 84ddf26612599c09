"""Expert parallelism (ep): a mixture-of-experts MLP sharded over an expert
mesh axis (whisper_tpu/parallel/expert.py).

No Whisper model has MoE layers; like the JAX module, this is the
demonstration that the mesh vocabulary extends to expert sharding:
  * top-1 (switch) routing in the GShard einsum form: dispatch and combine
    are one-hot einsums, no sorting or gather;
  * capacity-less: every expert sees every token position, zeroed where
    the token is routed elsewhere; exact, no dropped tokens;
  * the expert weights carry a leading E axis split over ep: each ep rank
    computes its E/ep experts for every token, and one all_reduce over ep
    combines them (where GSPMD inserts a psum in JAX).
With identical expert weights the layer equals the plain MLP for any
routing; sharded and unsharded give the same values, since every token
takes exactly one expert's output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.parallel.mesh import axis_group, shard_tensor


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32) -> dict:
    """Router and per-expert MLP weights (leading E axis), drawn from
    `generator` on its device (JAX draws from a PRNG key: the same
    distributions)."""
    s1 = (2.0 / d_model) ** 0.5
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {
        "router": {"w": (normal(d_model, n_experts) * 0.02).to(dtype)},
        "w1": (normal(n_experts, d_model, d_ff) * s1).to(dtype),
        "b1": torch.zeros((n_experts, d_ff), dtype=dtype, device=dev),
        "w2": (normal(n_experts, d_ff, d_model) * s1).to(dtype),
        "b2": torch.zeros((n_experts, d_model), dtype=dtype, device=dev),
    }


def moe_specs() -> dict:
    """The specs of the MoE tree: experts over ep, the router
    replicated."""
    return {
        "router": {"w": (None, None)},
        "w1": ("ep", None, None),
        "b1": ("ep", None),
        "w2": ("ep", None, None),
        "b2": ("ep", None),
    }


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's experts (and the router) of a whole MoE tree."""
    specs = moe_specs()

    def place(p, s):
        if isinstance(p, dict):
            return {k: place(p[k], s[k]) for k in p}
        return shard_tensor(p, s, mesh)
    return place(params, specs)


def _route(x: torch.Tensor, router_w: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(one-hot top-1 expert (B, T, E) in x's dtype, its gate (B, T, 1))."""
    gates = torch.softmax(torch.einsum("btd,de->bte", x.float(),
                                       router_w.float()), dim=-1)
    top = gates.argmax(dim=-1)                               # (B, T)
    onehot = F.one_hot(top, gates.shape[-1]).to(x.dtype)     # (B, T, E)
    return onehot, gates.gather(-1, top[..., None]).to(x.dtype)


def _experts(x, onehot, w1, b1, w2, b2) -> torch.Tensor:
    """Dispatch to the experts of w1/w2 (onehot's columns), their MLPs,
    and the combine: (B, T, d), each token's expert output or zeros."""
    xe = torch.einsum("btd,bte->ebtd", x, onehot)            # (E, B, T, d)
    h = F.gelu(torch.einsum("ebtd,edf->ebtf", xe, w1)
               + b1[:, None, None, :])
    ye = torch.einsum("ebtf,efd->ebtd", h, w2) + b2[:, None, None, :]
    return torch.einsum("ebtd,bte->btd", ye, onehot)


def moe_mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Top-1 switch MLP: (B, T, d) -> (B, T, d), every expert here."""
    onehot, gate_val = _route(x, params["router"]["w"])
    y = _experts(x, onehot, params["w1"], params["b1"], params["w2"],
                 params["b2"])
    return y * gate_val


def moe_mlp_sharded(x: torch.Tensor, params: dict, mesh,
                    batch_axis: Optional[str] = "dp") -> torch.Tensor:
    """moe_mlp with this rank's experts (shard_moe_params) on the mesh's
    ep axis and, with `batch_axis`, its rows of x over that axis: the
    rank's experts' outputs for its rows, summed over ep, then gathered
    over the batch axis. x: the whole batch, the same on every rank;
    returns the whole (B, T, d) on every rank."""
    rows = x if batch_axis is None else shard_tensor(
        x, (batch_axis, None, None), mesh).to(x.device)
    onehot, gate_val = _route(rows, params["router"]["w"])
    ep = axis_group(mesh, "ep")
    n_local = params["w1"].shape[0]
    lo = collectives.rank(ep) * n_local
    y = _experts(rows, onehot[..., lo:lo + n_local], params["w1"],
                 params["b1"], params["w2"], params["b2"])
    y = collectives.all_reduce(y, ep) * gate_val
    if batch_axis is None:
        return y
    return collectives.all_gather(y, axis_group(mesh, batch_axis), 0)
