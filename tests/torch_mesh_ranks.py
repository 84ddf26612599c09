"""Rank functions of the port's mesh tests (tests/test_torch_mesh.py,
test_torch_sharded_inference.py, test_torch_pipeline_parallel.py,
test_torch_expert_parallel.py, test_torch_multihost.py,
test_torch_dcp_checkpoints.py).

Each function runs in every process of a gloo world on the CPU that
whisper_tpu_torch.parallel.launch.run starts (one world per test module),
runs all of that module's rank-side checks, and returns numpy arrays and
plain values, which the test holds against the JAX package in its own
process. This module imports the port only: the ranks never import JAX
(the weights arrive as numpy trees)."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from whisper_tpu_torch import get_config, train, weights
from whisper_tpu_torch.decode import beam_decode, greedy_decode
from whisper_tpu_torch.models.whisper import (
    decoder_forward,
    encoder_forward,
    init_kv_cache,
    precompute_cross_kv,
)
from whisper_tpu_torch.parallel import multihost
from whisper_tpu_torch.parallel import pipeline_parallel as ppl
from whisper_tpu_torch.parallel.expert import (
    moe_mlp_sharded,
    shard_moe_params,
)
from whisper_tpu_torch.parallel.inference import ShardedPipeline
from whisper_tpu_torch.parallel.mesh import (
    axes_mesh,
    make_mesh,
    param_pspecs,
    sanitize_pspec,
    shard_params,
    shard_tensor,
)

WORLD = 4


def shard_nano():
    """The JAX sharded-inference tests' config (d 64, 4 heads, 2 + 2
    layers, the full 1500 encoder frames)."""
    return get_config("tiny").replace(
        name="shard-nano", d_model=64, n_heads=4, n_audio_layers=2,
        n_text_layers=2, n_audio_ctx=1500, n_text_ctx=448)


def pp_nano():
    """The JAX pipeline tests' config (4 + 4 layers, 32 frames, a 512-row
    vocabulary)."""
    return get_config("tiny").replace(
        name="pp-nano", d_model=64, n_heads=4, n_audio_layers=4,
        n_text_layers=4, n_audio_ctx=32, n_text_ctx=16, vocab_size=512,
        eot_token=500, n_languages=8)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _dp_rows(mesh, x):
    """This rank's dp rows of a numpy batch, as a tensor."""
    return shard_tensor(torch.as_tensor(x), ("dp",), mesh)


def _flat(tree) -> dict:
    return {k: _np(v) for k, v in weights._keystr_leaves(tree)}


# ---------------------------------------------------------------------------
# test_torch_mesh.py
# ---------------------------------------------------------------------------

def mesh_rank(params_np, mel, prompt) -> dict:
    """make_mesh's axes and errors, sanitize_pspec, shard_params' local
    shards on a (dp, tp) and a (tp, pp) mesh, and the prefill logits at
    tp = 4 (the padded vocabulary)."""
    cfg = shard_nano()
    params = weights.from_jax_params(params_np)
    out = {}
    m = make_mesh(dp=2, tp=2, device_type="cpu")
    out["axes"] = (tuple(m.mesh_dim_names), tuple(m.shape))
    try:
        make_mesh(dp=3, tp=2, device_type="cpu")
        out["mismatch_raises"] = False
    except ValueError:
        out["mismatch_raises"] = True
    out["sanitize"] = [
        sanitize_pspec((51865, 64), ("tp", None), m),
        sanitize_pspec((128, 384), (None, "tp"), m),
        sanitize_pspec((64, 3), (("dp", "tp"), None), m),
        sanitize_pspec((8, 8, 8), ("tp",), m),
        sanitize_pspec((9, 8, 8), ("tp",), m),
    ]
    out["shards_dp_tp"] = _flat(shard_params(params, m))
    mp = make_mesh(tp=2, pp=2, device_type="cpu")
    out["shards_tp_pp"] = _flat(shard_params(params, mp))
    out["pspecs_pp"] = dict(weights._keystr_leaves(
        param_pspecs(params, pipeline=True)))
    pipe = ShardedPipeline(params, cfg, dp=1, tp=4, device="cpu")
    out["vocab_rows"] = int(pipe.params["decoder"]["tok_emb"].shape[0])
    out["logits_tp4"] = _prefill(pipe, cfg, mel, prompt)
    return out


def _prefill(pipe, cfg, mel, prompt) -> np.ndarray:
    """The rank's prefill logits (its dp rows) on the pipeline's shard."""
    with torch.inference_mode(), pipe.sharding():
        m = pipe.rows(mel)
        enc = encoder_forward(pipe.params, cfg, m)
        cross = precompute_cross_kv(pipe.params, cfg, enc)
        cache = init_kv_cache(cfg, m.shape[0], torch.float32, 64, "cpu")
        logits, _ = decoder_forward(pipe.params, cfg, pipe.rows(prompt), 0,
                                    cache, cross)
    return _np(logits)


# ---------------------------------------------------------------------------
# test_torch_sharded_inference.py
# ---------------------------------------------------------------------------

PREFILL_MESHES = ((4, 1, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2))


def inference_rank(params_np, mel, prompt, decisive_np, enc, dprompt,
                   audio) -> dict:
    """Prefill logits on every mesh of PREFILL_MESHES (dp, tp, sp);
    greedy and beam-2 tokens under the decisive weights; transcribe_batch;
    the batch-divides-dp error."""
    cfg = shard_nano()
    params = weights.from_jax_params(params_np)
    out = {"prefill": {}}
    for dp, tp, sp in PREFILL_MESHES:
        pipe = ShardedPipeline(params, cfg, dp=dp, tp=tp, sp=sp,
                               device="cpu")
        out["prefill"][dp, tp, sp] = _prefill(pipe, cfg, mel, prompt)
    decisive = weights.from_jax_params(decisive_np)
    out["greedy"], out["beam"] = {}, {}
    for dp, tp in ((2, 2), (1, 4)):
        pipe = ShardedPipeline(decisive, cfg, dp=dp, tp=tp, device="cpu")
        with torch.inference_mode(), pipe.sharding():
            res = greedy_decode(pipe.params, cfg, pipe.rows(enc),
                                pipe.rows(dprompt), max_new=12)
            out["greedy"][dp, tp] = (_np(res.tokens), _np(res.lengths))
            if (dp, tp) == (2, 2):
                res = beam_decode(pipe.params, cfg, pipe.rows(enc),
                                  pipe.rows(dprompt), beam_size=2,
                                  max_new=8)
                out["beam"][dp, tp] = (_np(res.tokens), _np(res.lengths))
    pipe = ShardedPipeline(decisive, cfg, dp=2, tp=2, device="cpu")
    out["transcribe"] = pipe.transcribe_batch(audio, max_new=5)
    pipe = ShardedPipeline(params, cfg, dp=4, tp=1, device="cpu")
    try:
        pipe.transcribe_batch(audio[:3], max_new=2)
        out["dp_raises"] = False
    except ValueError:
        out["dp_raises"] = True
    return out


# ---------------------------------------------------------------------------
# test_torch_pipeline_parallel.py
# ---------------------------------------------------------------------------

PP_TRAIN_MESHES = ((1, 1, 1, 4), (4, 1, 1, 1), (1, 1, 2, 2), (1, 2, 1, 2))


def _pp_mesh(dp=1, sp=1, tp=1, pp=1):
    return make_mesh(dp=dp, sp=sp, tp=tp, pp=pp, device_type="cpu")


def pipeline_rank(Ws, h, Ws8, h8, aux8, params_np, mel, tokens, enc,
                  mask) -> dict:
    """pipelined_scan against the plain loop, pass-through state, the
    indivisible error; encoder_forward_pp and decoder_logits_pp; one
    train_step_pp on every mesh of PP_TRAIN_MESHES (dp, sp, tp, pp):
    loss, global norm and the rank's (clipped) gradient shards."""
    out = {}
    mesh = _pp_mesh(pp=4)
    Ws, h = torch.from_numpy(Ws), torch.from_numpy(h)

    def block(x, W):
        return torch.tanh(x @ W)

    plain = h
    for W in Ws:
        plain = block(plain, W)
    out["scan_plain"] = _np(plain)
    out["scan"] = {M: _np(ppl.pipelined_scan(block, h, Ws, mesh,
                                             microbatches=M))
                   for M in (2, 4, 8)}
    st = ppl.pipelined_scan(
        lambda s, W: {"h": torch.tanh(s["h"] @ W), "aux": s["aux"]},
        {"h": torch.from_numpy(h8), "aux": torch.from_numpy(aux8)},
        torch.from_numpy(Ws8), mesh, microbatches=4)
    out["passthrough"] = (_np(st["h"]), _np(st["aux"]))
    try:
        ppl.pipelined_scan(lambda x, w: x, torch.zeros(4, 4),
                           torch.zeros(6, 4, 4), mesh)
        out["indivisible_raises"] = None
    except ValueError as e:
        out["indivisible_raises"] = str(e)

    cfg = pp_nano()
    params = weights.from_jax_params(params_np)
    out["enc_pp"], out["dec_pp"] = {}, {}
    for axes in ((1, 1, 1, 4), (1, 1, 2, 2), (2, 1, 1, 2)):
        m = _pp_mesh(*axes)
        local = weights.to_device(shard_params(params, m), "cpu")
        with torch.inference_mode():
            out["enc_pp"][axes] = _np(ppl.encoder_forward_pp(
                local, cfg, _dp_rows(m, mel), m, microbatches=2 if axes[0]
                == 1 else 1))
            out["dec_pp"][axes] = _np(ppl.decoder_logits_pp(
                local, cfg, _dp_rows(m, tokens), _dp_rows(m, enc), m,
                microbatches=2 if axes[0] == 1 else 1))
    out["train"] = {}
    for axes in PP_TRAIN_MESHES:
        m = _pp_mesh(*axes)
        p = weights.trainable(shard_params(params, m), "cpu")
        opt = train.make_optimizer(p)
        batch = train.TrainBatch(_dp_rows(m, mel), _dp_rows(m, tokens),
                                 _dp_rows(m, mask))
        res = ppl.train_step_pp(p, opt, cfg, batch, m,
                                microbatches=1 if axes[0] > 1 else 2)
        grads = weights.from_device(
            weights._map_leaves(lambda t: t.grad, p))
        out["train"][axes] = (float(res["loss"]), float(res["grad_norm"]),
                              _flat(grads))
    return out


# ---------------------------------------------------------------------------
# test_torch_expert_parallel.py
# ---------------------------------------------------------------------------

def expert_rank(params_np, x) -> dict:
    """moe_mlp_sharded at (dp, ep) = (1, 4) and (2, 2)."""
    params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in params_np.items()}
    out = {}
    for dp, ep in ((1, 4), (2, 2)):
        mesh = axes_mesh({"dp": dp, "ep": ep}, "cpu")
        local = shard_moe_params(params, mesh)
        out[dp, ep] = (_np(moe_mlp_sharded(torch.from_numpy(x), local, mesh,
                                           batch_axis="dp")),
                       int(local["w1"].shape[0]))
    return out


# ---------------------------------------------------------------------------
# test_torch_multihost.py
# ---------------------------------------------------------------------------

def multihost_rank(rows) -> dict:
    """initialize inside a world (a no-op), is_coordinator, global_batch
    from each rank's dp rows, global_batch_size."""
    multihost.initialize()                 # the group exists: a no-op
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    mine = _np(_dp_rows(mesh, rows))
    whole = multihost.global_batch(mine, mesh)
    return {"coordinator": multihost.is_coordinator(),
            "rank": dist.get_rank(), "global": _np(whole),
            "size": multihost.global_batch_size(mine.shape[0]),
            "host": _host_transport()}


def _host_transport() -> dict:
    """The "host" transport (a CUDA tensor on gloo, forced here on CPU
    tensors) of send/recv, all_gather and all_reduce, in place too, on a
    transposed (not contiguous) input: rank r's x is the (4, 3)
    transpose of arange(12) + 100 r."""
    from whisper_tpu_torch.ops import collectives
    group, r = dist.group.WORLD, dist.get_rank()
    x = (torch.arange(12.0).reshape(3, 4) + 100 * r).t()
    assert not x.is_contiguous()
    saved = collectives.transport
    collectives.transport = lambda op, t, g: "host"
    try:
        if r == 0:
            collectives.send(x, 1, group)
        got = collectives.recv(x, 0, group) if r == 1 else x
        out = {"recv": _np(got),
               "gather": _np(collectives.all_gather(x, group, 0)),
               "reduce": _np(collectives.all_reduce(x, group))}
        y = x.clone().t().contiguous().t()        # not contiguous, owned
        z = collectives.all_reduce(y, group, inplace=True)
        out["reduce_inplace"] = _np(y)
        out["inplace_is_x"] = z is y
    finally:
        collectives.transport = saved
    return out


# ---------------------------------------------------------------------------
# test_torch_dcp_checkpoints.py
# ---------------------------------------------------------------------------

def dcp_rank(params_np, directory: str) -> dict:
    """save_dcp at tp = 4 and at (tp, pp) = (2, 2), each restored at (dp,
    tp) = (2, 2) against shard_params there; a plain-tensor save of one
    (4, 2) tensor's shards against a DTensor save."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = shard_nano()
    params = weights.from_jax_params(params_np)
    out = {}
    m4 = make_mesh(tp=4, device_type="cpu")
    weights.save_dcp(f"{directory}/tp4", weights.to_device(
        shard_params(params, m4), "cpu"), cfg, m4)
    mpp = make_mesh(tp=2, pp=2, device_type="cpu")
    weights.save_dcp(f"{directory}/tp2pp2", shard_params(params, mpp), cfg,
                     mpp)
    m22 = make_mesh(dp=2, tp=2, device_type="cpu")
    want = dict(weights._keystr_leaves(shard_params(params, m22)))
    for name in ("tp4", "tp2pp2"):
        got = dict(weights._keystr_leaves(
            weights.load_dcp(f"{directory}/{name}", cfg, m22)))
        out[name] = {k: bool(torch.equal(got[k], want[k])) for k in want}
    got = dict(weights._keystr_leaves(
        weights.load_dcp(f"{directory}/tp4", cfg, mpp)))
    want = dict(weights._keystr_leaves(shard_params(params, mpp)))
    out["tp4_to_tp2pp2"] = {k: bool(torch.equal(got[k], want[k]))
                            for k in want}

    whole = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    shard = whole.chunk(WORLD)[dist.get_rank()].clone()
    dcp.save({"x": shard}, checkpoint_id=f"{directory}/plain")
    dcp.save({"x": DTensor.from_local(shard, m4, [Replicate(), Replicate(),
                                                  Shard(0)])},
             checkpoint_id=f"{directory}/dtensor")
    out["sizes"] = {
        name: tuple(FileSystemReader(f"{directory}/{name}").read_metadata()
                    .state_dict_metadata["x"].size)
        for name in ("plain", "dtensor")}
    return out


def block(x: np.ndarray, spec: tuple, axes: dict, rank: int) -> np.ndarray:
    """Rank `rank`'s block of a global array under `spec` on a mesh of
    `axes` ({name: size} in mesh order, ranks row-major), as
    mesh.shard_tensor takes it."""
    coord = dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, idx = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n, idx = n * axes[a], idx * axes[a] + int(coord[a])
        x = np.split(x, n, axis=dim)[idx]
    return x


def fail_on_rank_1():
    """Rank 1 raises; the launcher must report it and stop the world."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()              # rank 0 waits for a peer that never comes


def hang():
    """Every rank sleeps past the launcher's timeout."""
    import time
    time.sleep(120)
