"""Pipeline parallelism: a GPipe microbatch schedule over the `pp` mesh
axis (whisper_tpu/parallel/pipeline_parallel.py).

Each pp rank owns L/pp contiguous layers of a stacked-layer stack (the
`layers` leaves of mesh.shard_params' tree, pipeline=True). The schedule
is plain GPipe: rank 0 takes microbatch m of the state, every other rank
receives it from rank - 1, runs its layers and sends the result to rank
+ 1 (point-to-point send/recv; M microbatches over M + pp - 1 ticks, of
which (pp - 1) idle per rank). The last rank's results go to every rank
(a broadcast, where JAX psums zero-masked copies). The carried state is a
dict of tensors, so stages can thread pass-through operands (the decoder
carries its microbatch's encoder output for cross-attention).

Autograd stops at send/recv, so the schedule is one autograd Function
whose backward runs GPipe in reverse: every rank's gradient of the
broadcast result is summed over pp; the last rank back-propagates each
microbatch through its stage (the graph the forward kept: the stage's
input and output), sends the input's gradient to rank - 1, and so on down
to rank 0, whose input gradients are the schedule's. The stage's
parameter gradients come back through the Function.

Gradients of the leaves outside the stacks: every rank computes the
replicated head (final LayerNorm, logits, loss), so train_step_pp
back-propagates loss / pp on each rank and sums those leaves' gradients
over pp. The head's gradient is then counted once, and the embeddings'
and the conv stem's, which only rank 0's stage input reaches, too.

The stages run inside models.whisper.sharded with the mesh's tp and sp
groups, so the pipeline composes with tensor and sequence parallelism;
each dp rank passes its own rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.models.whisper import (
    compute_dtype,
    encoder_input,
    encoder_output,
    final_logits,
    full_fp32,
    gelu,
    layer_index,
    layer_norm,
    local_heads,
    merge_heads,
    qkv_fused,
    sharded,
    split_heads,
    split_heads_hm,
    tok_embed,
    tp_linears,
    tree_leaves,
)
from whisper_tpu_torch.ops.attention import multi_head_attention
from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.parallel.mesh import axis_group, axis_size, param_pspecs
from whisper_tpu_torch.train import TrainBatch, optimizer_step

Params = Any
State = dict


def _as_state(x) -> tuple[State, bool]:
    """A state dict, and whether x was a bare tensor."""
    return (x, False) if isinstance(x, dict) else ({"x": x}, True)


def _chunk(state: State, M: int) -> list[State]:
    """M microbatches along the batch axis."""
    parts = {k: v.chunk(M) for k, v in state.items()}
    return [{k: parts[k][m] for k in state} for m in range(M)]


def _cat(states: list[State]) -> State:
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


class _GPipe:
    """One schedule: the rank's stage (its local layers), the pp group and
    the microbatch count."""

    def __init__(self, block_fn: Callable, local_stack, group, M: int):
        self.block_fn, self.stack, self.group, self.M = (block_fn,
                                                         local_stack, group, M)
        self.pp, self.rank = collectives.size(group), collectives.rank(group)
        self.n_layers = next(tree_leaves(local_stack)).shape[0]
        self.saved: list[tuple[State, State]] = []

    def stage(self, x: State) -> State:
        for i in range(self.n_layers):
            x = self.block_fn(x, layer_index(self.stack, i))
        return x

    def forward(self, state: State, keep_graph: bool) -> State:
        """The schedule's forward; with keep_graph each microbatch's stage
        runs under autograd on a detached input, both kept for backward."""
        keys = sorted(state)
        mbs = _chunk(state, self.M)
        outs = []
        for m in range(self.M):
            if self.rank == 0:
                x = mbs[m]
            else:
                x = {k: collectives.recv(mbs[m][k], self.rank - 1, self.group)
                     for k in keys}
            if keep_graph:
                x = {k: v.detach().requires_grad_(v.is_floating_point())
                     for k, v in x.items()}
                with torch.enable_grad():
                    y = self.stage(x)
                self.saved.append((x, y))
            else:
                y = self.stage(x)
            if self.rank < self.pp - 1:
                for k in keys:
                    collectives.send(y[k].detach(), self.rank + 1, self.group)
            else:
                outs.append({k: y[k].detach() for k in keys})
        if self.rank == self.pp - 1:
            out = _cat(outs)
        else:
            out = {k: torch.empty_like(state[k]) for k in keys}
        return {k: collectives.broadcast(out[k], self.pp - 1, self.group)
                for k in keys}

    def backward(self, grads: State, params: list) -> tuple[State, list]:
        """GPipe in reverse over the kept graphs: (the gradient of the
        state input, zero off rank 0; the gradients of `params`)."""
        keys = sorted(grads)
        grads = {k: collectives.all_reduce(g, self.group)
                 for k, g in grads.items()}
        g_mbs = _chunk(grads, self.M)
        g_in: list[Optional[State]] = [None] * self.M
        g_params = [None] * len(params)
        for m in reversed(range(self.M)):
            x, y = self.saved[m]
            if self.rank == self.pp - 1:
                gy = g_mbs[m]
            else:
                gy = {k: collectives.recv(g_mbs[m][k], self.rank + 1,
                                          self.group) for k in keys}
            outs = [k for k in keys if y[k].requires_grad]
            ins = [x[k] for k in keys if x[k].requires_grad]
            got = torch.autograd.grad([y[k] for k in outs], ins + params,
                                      [gy[k] for k in outs],
                                      allow_unused=True)
            by_key = dict(zip([k for k in keys if x[k].requires_grad],
                              got[:len(ins)]))
            gx = {k: (by_key.get(k) if by_key.get(k) is not None
                      else torch.zeros_like(x[k])) for k in keys}
            for i, g in enumerate(got[len(ins):]):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            if self.rank > 0:
                for k in keys:
                    collectives.send(gx[k], self.rank - 1, self.group)
            else:
                g_in[m] = gx
        self.saved.clear()
        if self.rank == 0:
            return _cat(g_in), g_params
        return {k: torch.zeros_like(g) for k, g in grads.items()}, g_params


class _Pipelined(torch.autograd.Function):
    """The schedule as one differentiable op: inputs the state leaves (in
    sorted key order) and the rank's stage parameters."""

    @staticmethod
    def forward(ctx, run: _GPipe, keys: tuple, n_state: int, *tensors):
        state = dict(zip(keys, tensors[:n_state]))
        ctx.run, ctx.keys, ctx.n_state = run, keys, n_state
        ctx.params = list(tensors[n_state:])
        out = run.forward(state, keep_graph=True)
        return tuple(out[k] for k in keys)

    @staticmethod
    def backward(ctx, *grads):
        g_state, g_params = ctx.run.backward(dict(zip(ctx.keys, grads)),
                                             ctx.params)
        return (None, None, None, *(g_state[k] for k in ctx.keys),
                *g_params)


def _pipeline(block_fn: Callable, state, local_stack, group, M: int):
    """Run block_fn over every layer of the pipelined stack, this rank
    holding `local_stack`."""
    state, bare = _as_state(state)
    if bare:
        fn = block_fn

        def block_fn(st, lp):
            return {"x": fn(st["x"], lp)}
    run = _GPipe(block_fn, local_stack, group, M)
    params = [p for p in tree_leaves(local_stack)]
    keys = tuple(sorted(state))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*state.values(), *params)):
        out = dict(zip(keys, _Pipelined.apply(
            run, keys, len(keys), *(state[k] for k in keys), *params)))
    else:
        out = run.forward(state, keep_graph=False)
    return out["x"] if bare else out


def _check_batch(state, M: int) -> None:
    B = next(iter(_as_state(state)[0].values())).shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")


def pipelined_scan(block_fn: Callable, state, stacked, mesh,
                   microbatches: Optional[int] = None,
                   pp_axis: str = "pp"):
    """The layer loop `for l: state = block_fn(state, stacked[l])` with the
    layer axis pipelined over `pp_axis` (:65), equal to the plain loop.

    Args:
      block_fn: (state, layer slice) -> state, shapes and dtypes kept.
      state: a tensor or a dict of tensors, each (B, ...).
      stacked: a tensor or dict tree with the leading layer axis L on
        every leaf, the whole stack on every rank; L % pp == 0. Each rank
        runs its L/pp layers (the forwards below take the rank's own
        layers from shard_params instead).
      mesh: a mesh with `pp_axis` (a mesh without it runs the plain loop).
      microbatches: M (default pp); B % M == 0. A larger M shrinks the
        bubble: (pp - 1)/(M + pp - 1) of the ticks are idle per rank.
    Returns the final state, shaped as `state`, on every rank."""
    names = mesh.mesh_dim_names or ()
    pp = axis_size(mesh, pp_axis) if pp_axis in names else 1
    L = next(tree_leaves(stacked)).shape[0]
    if pp == 1:
        for i in range(L):
            state = block_fn(state, layer_index(stacked, i))
        return state
    if L % pp:
        raise ValueError(f"{L} layers not divisible by pp={pp}")
    M = microbatches or pp
    _check_batch(state, M)
    r, n = mesh.get_local_rank(pp_axis), L // pp

    def local(t):
        if isinstance(t, dict):
            return {k: local(v) for k, v in t.items()}
        return t[r * n:(r + 1) * n]

    return _pipeline(block_fn, state, local(stacked),
                     mesh.get_group(pp_axis), M)


def _stack_pipeline(mesh, block_fn, state, layers, n_layers: int,
                    microbatches: Optional[int]):
    """A forward's block stack: this rank's layers of n_layers over pp
    (the plain loop without a pp axis)."""
    group = axis_group(mesh, "pp")
    local = next(tree_leaves(layers)).shape[0]
    pp = collectives.size(group)
    if n_layers % pp or local * pp != n_layers:
        raise ValueError(f"{n_layers} layers not divisible by pp={pp}, or "
                         f"this rank holds {local} of them")
    if group is None:
        for i in range(local):
            state = block_fn(state, layer_index(layers, i))
        return state
    M = microbatches or pp
    _check_batch(state, M)
    return _pipeline(block_fn, state, layers, group, M)


def _mesh_sharding(mesh):
    """The model's tp/sp block for this mesh."""
    return sharded(tp=axis_group(mesh, "tp"), sp=axis_group(mesh, "sp"))


# ---------------------------------------------------------------------------
# pipelined model forwards (training / prefill shapes, full sequences)
# ---------------------------------------------------------------------------

def encoder_forward_pp(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
                       mesh, microbatches: Optional[int] = None
                       ) -> torch.Tensor:
    """encoder_forward with the block stack pipelined over pp (:156):
    the stem, the same block math as the tail-off branch (attention
    through multi_head_attention, so the flash kernel at encoder sizes on
    the card) and the final LayerNorm. params: the rank's to_device tree
    of shard_params(pipeline=True); mel: the rank's dp rows."""
    enc = params["encoder"]
    tp, sp = axis_group(mesh, "tp"), axis_group(mesh, "sp")
    col, row = tp_linears(tp)
    heads = local_heads(cfg, tp)

    def block(state, lp):
        h = state["h"]
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k, v = qkv_fused(y, lp["attn"], heads, col)
        k, v = (collectives.gather_partial(t, sp, 2) for t in (k, v))
        a = merge_heads(multi_head_attention(q, k, v,
                                             backend=cfg.attn_backend))
        h = h + row(a, lp["attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        return {"h": h + row(gelu(col(y, lp["fc1"])), lp["fc2"])}

    with _mesh_sharding(mesh):
        x = encoder_input(enc, cfg, mel)
        state = _stack_pipeline(mesh, block, {"h": x}, enc["layers"],
                                cfg.n_audio_layers, microbatches)
        return encoder_output(enc, cfg, state["h"])


def decoder_logits_pp(params: Params, cfg: WhisperConfig,
                      tokens: torch.Tensor, enc_out: torch.Tensor, mesh,
                      microbatches: Optional[int] = None) -> torch.Tensor:
    """Teacher-forced full-sequence decoder logits with the block stack
    pipelined over pp (:196): decoder_forward from an empty cache with
    kv_len = T, the cross K/V projected inside each stage from the encoder
    output the state carries (each rank owns its layers' cross weights).
    Returns (B, T, vocab_size) fp32 on every rank."""
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    T = tokens.shape[1]
    col, row = tp_linears(axis_group(mesh, "tp"))
    heads = local_heads(cfg, axis_group(mesh, "tp"))

    def block(state, lp):
        h, enc = state["h"], state["enc"]
        y = layer_norm(h, lp["attn_ln"]["g"], lp["attn_ln"]["b"], cfg.ln_eps)
        q, k, v = qkv_fused(y, lp["attn"], heads, col)
        a = merge_heads(multi_head_attention(q, k, v, causal=True,
                                             backend=cfg.attn_backend))
        h = h + row(a, lp["attn"]["o"])
        y = layer_norm(h, lp["cross_ln"]["g"], lp["cross_ln"]["b"],
                       cfg.ln_eps)
        q = split_heads(col(y, lp["cross_attn"]["q"]), heads)
        xk = split_heads_hm(col(enc, lp["cross_attn"]["k"]), heads)
        xv = split_heads_hm(col(enc, lp["cross_attn"]["v"]), heads)
        a = merge_heads(multi_head_attention(q, xk, xv,
                                             backend=cfg.attn_backend))
        h = h + row(a, lp["cross_attn"]["o"])
        y = layer_norm(h, lp["mlp_ln"]["g"], lp["mlp_ln"]["b"], cfg.ln_eps)
        h = h + row(gelu(col(y, lp["fc1"])), lp["fc2"])
        return {"h": h, "enc": enc}

    with _mesh_sharding(mesh):
        h = tok_embed(dec, tokens, dtype) + dec["pos_emb"][:T].to(dtype)
        state = _stack_pipeline(mesh, block,
                                {"h": h, "enc": enc_out.to(dtype)},
                                dec["layers"], cfg.n_text_layers,
                                microbatches)
        return final_logits(params, cfg, state["h"])


# ---------------------------------------------------------------------------
# pipelined training step (dp x sp x tp x pp)
# ---------------------------------------------------------------------------

def loss_fn_pp(params: Params, cfg: WhisperConfig, batch: TrainBatch, mesh,
               microbatches: Optional[int] = None) -> torch.Tensor:
    """train.loss_fn with both block stacks pipelined (:252): the masked
    mean cross-entropy over the GLOBAL batch, each dp rank passing its
    rows. The value is the global loss on every rank; its gradient is this
    rank's share (the dp sum of the shares is the global gradient)."""
    if compute_dtype(cfg) != torch.float32:
        raise ValueError(f"loss_fn_pp: training runs in float32 only "
                         f"(got {cfg.compute_dtype!r})")
    dev = params["decoder"]["tok_emb"].device
    mel = torch.as_tensor(batch.mel, dtype=torch.float32, device=dev)
    tokens = torch.as_tensor(batch.tokens, device=dev).long()
    mask = torch.as_tensor(batch.loss_mask, dtype=torch.float32, device=dev)
    dp = axis_group(mesh, "dp")
    with full_fp32():
        enc_out = encoder_forward_pp(params, cfg, mel, mesh, microbatches)
        logits = decoder_logits_pp(params, cfg, tokens, enc_out, mesh,
                                   microbatches)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        m = mask[:, :-1]
        total = collectives.reduce_from((nll * m).sum(), dp)
        return total / collectives.all_reduce(m.sum(), dp).clamp_min(1.0)


def _reduce_grads(params: Params, mesh, specs: Params) -> list:
    """Every leaf's gradient summed over the axes whose ranks hold partial
    gradients of it: dp (each rank's rows), pp for the leaves outside the
    pipelined stacks (see the module docstring), sp for the encoder's
    (each rank's frames). Returns [(leaf, its axes of sharding)]."""
    groups = {a: axis_group(mesh, a) for a in ("dp", "sp", "tp", "pp")}
    out = []

    def walk(p, s, encoder: bool):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], encoder)
            return
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        sharded_over = {a for a in s if a is not None}
        summed = ["dp"] + (["pp"] if "pp" not in sharded_over else []) \
            + (["sp"] if encoder else [])
        for axis in summed:
            collectives.all_reduce(p.grad, groups[axis], inplace=True)
        out.append((p, sharded_over))

    for part in params:
        walk(params[part], specs[part], part == "encoder")
    return out


def _global_norm(leaves: list, mesh) -> torch.Tensor:
    """optax.global_norm of the whole (unsharded) gradient: each leaf's
    sum of squares, summed over the ranks that hold its shards."""
    by_axes: dict[tuple, list] = {}
    for p, axes in leaves:
        by_axes.setdefault(tuple(sorted(axes)), []).append(
            p.grad.float().square().sum())
    total = 0.0
    for axes, sq in by_axes.items():
        s = torch.stack(sq).sum()
        for a in axes:
            s = collectives.all_reduce(s, axis_group(mesh, a))
        total = total + s
    return torch.as_tensor(total).sqrt()


def train_step_pp(params: Params, opt, cfg: WhisperConfig, batch: TrainBatch,
                  mesh, microbatches: Optional[int] = None
                  ) -> dict[str, torch.Tensor]:
    """One update (:265) in place on the rank's `weights.trainable` leaves
    of shard_params(pipeline=True)'s tree, on any (dp, sp, tp, pp) mesh:
    the pipelined loss, the GPipe backward, the gradients summed where
    ranks hold partial ones (_reduce_grads), then train.optimizer_step
    with the clip by the global norm of the whole gradient. Every rank's
    leaves move as the one-card train_step would move the same values.
    Returns {"loss", "grad_norm"} as 0-d tensors, the same on every
    rank. Assumes every sharded dimension divides (true of every Whisper
    shape at a tp that divides n_heads)."""
    pp = collectives.size(axis_group(mesh, "pp"))
    opt.adamw.zero_grad(set_to_none=True)
    specs = param_pspecs(params, pipeline=pp > 1)
    with full_fp32():
        loss = loss_fn_pp(params, cfg, batch, mesh, microbatches)
        (loss / pp).backward()
        leaves = _reduce_grads(params, mesh, specs)
        norm = optimizer_step(params, opt, norm=_global_norm(leaves, mesh))
    return {"loss": loss.detach(), "grad_norm": norm}
