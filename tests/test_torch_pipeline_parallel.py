"""The port's pipeline parallelism (whisper_tpu_torch/parallel/
pipeline_parallel.py) against the JAX package's unsharded model:
pipelined_scan equal to the plain layer loop at M = 2, 4, 8 and close to
JAX's scan, a pass-through state, the indivisible error; the pipelined
encoder and decoder at pp = 4 and beside tp and dp; and one train_step_pp
at pp = 4, at dp = 4 (the data-parallel step), at tp x pp = 2 x 2 and at
sp x pp = 2 x 2: the loss within 1e-4 relative of JAX's loss_fn, the
global norm likewise, and every rank's clipped gradient shard within 1e-4
of the largest |g| of JAX's clipped gradient. One gloo world of 4 CPU
processes runs every rank-side check (tests/torch_mesh_ranks.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from whisper_tpu.config import get_config
from whisper_tpu.models.whisper import (
    decoder_forward,
    encoder_forward,
    init_kv_cache,
    init_params,
    precompute_cross_kv,
)
from whisper_tpu.train import TrainBatch, loss_fn
from whisper_tpu_torch import weights
from whisper_tpu_torch.parallel import launch
from whisper_tpu_torch.parallel.mesh import param_pspecs

WORLD_TIMEOUT_S = 300
ENC_ATOL, DEC_ATOL, RTOL = 1e-5, 2e-4, 1e-5
LOSS_RTOL = 1e-4
GRAD_SHARE = 1e-4          # of the largest |g| over the whole gradient
ENC_MESHES = ((1, 1, 1, 4), (1, 1, 2, 2), (2, 1, 1, 2))   # dp, sp, tp, pp


def _axes(dp, sp, tp, pp):
    axes = {"dp": dp, "sp": sp, "tp": tp}
    return {**axes, "pp": pp} if pp > 1 else axes


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("tiny").replace(
        name="pp-nano", d_model=64, n_heads=4, n_audio_layers=4,
        n_text_layers=4, n_audio_ctx=32, n_text_ctx=16, vocab_size=512,
        eot_token=500, n_languages=8)
    params = init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    Ws = (rng.randn(4, 16, 16) * 0.3).astype(np.float32)
    h = rng.randn(8, 3, 16).astype(np.float32)
    Ws8 = (rng.randn(8, 8, 8) * 0.2).astype(np.float32)
    h8 = rng.randn(4, 8).astype(np.float32)
    aux8 = rng.randn(4, 3).astype(np.float32)
    B = 4
    mel = (rng.randn(B, cfg.n_mels, 2 * cfg.n_audio_ctx) * 0.5).astype(
        np.float32)
    tokens = rng.randint(0, cfg.vocab_size, (B, cfg.n_text_ctx))
    mask = np.ones((B, cfg.n_text_ctx), np.float32)
    mask[1, 10:] = 0.0
    enc = np.asarray(jax.jit(encoder_forward, static_argnums=1)(params, cfg,
                                                                mel))
    out = launch.run(
        "torch_mesh_ranks:pipeline_rank", ranks.WORLD,
        (Ws, h, Ws8, h8, aux8, jax.tree.map(np.asarray, params), mel,
         tokens.astype(np.int64), enc, mask), timeout=WORLD_TIMEOUT_S)
    return cfg, params, (Ws, h, Ws8, h8, aux8), mel, tokens, mask, enc, out


@pytest.mark.parametrize("M", [2, 4, 8])
def test_pipelined_scan_matches_scan(setup, M):
    *_, (Ws, h, *_), _, _, _, _, out = setup
    want, _ = jax.lax.scan(lambda c, W: (jnp.tanh(c @ W), None), h, Ws)
    for r in out:
        np.testing.assert_array_equal(r["scan"][M], r["scan_plain"])
        np.testing.assert_allclose(r["scan"][M], np.asarray(want),
                                   atol=1e-6)


def test_pipelined_scan_pytree_state_passthrough(setup):
    *_, (_, _, Ws8, h8, aux8), _, _, _, _, out = setup
    want, _ = jax.lax.scan(lambda c, W: (jnp.tanh(c @ W), None), h8, Ws8)
    for r in out:
        np.testing.assert_allclose(r["passthrough"][0], np.asarray(want),
                                   atol=1e-6)
        np.testing.assert_array_equal(r["passthrough"][1], aux8)


def test_pipelined_scan_rejects_indivisible(setup):
    *_, out = setup
    for r in out:
        assert "not divisible" in r["indivisible_raises"]


def _rows(out, axes, key):
    """The global batch of one mesh's per-rank results (dp order)."""
    dp = axes[0]
    step = ranks.WORLD // dp
    return np.concatenate([out[r][key][axes]
                           for r in range(0, ranks.WORLD, step)])


@pytest.mark.parametrize("axes", ENC_MESHES,
                         ids=lambda a: "dp%d_sp%d_tp%d_pp%d" % a)
def test_encoder_pp_matches_unsharded(setup, axes):
    _, _, _, _, _, _, enc, out = setup
    np.testing.assert_allclose(_rows(out, axes, "enc_pp"), enc,
                               atol=ENC_ATOL, rtol=RTOL)


@functools.lru_cache(maxsize=1)
def _jax_decoder_jit():
    def fwd(params, cfg, enc, tokens):
        cross = precompute_cross_kv(params, cfg, enc)
        logits, _ = decoder_forward(params, cfg, tokens, jnp.int32(0),
                                    init_kv_cache(cfg, tokens.shape[0]),
                                    cross)
        return logits
    return jax.jit(fwd, static_argnums=1)


def _jax_decoder(params, cfg, enc, tokens):
    return _jax_decoder_jit()(params, cfg, jnp.asarray(enc),
                              jnp.asarray(tokens, jnp.int32))


@pytest.mark.parametrize("axes", ENC_MESHES,
                         ids=lambda a: "dp%d_sp%d_tp%d_pp%d" % a)
def test_decoder_pp_matches_unsharded(setup, axes):
    cfg, params, _, _, tokens, _, enc, out = setup
    want = _jax_decoder(params, cfg, enc, tokens)
    np.testing.assert_allclose(_rows(out, axes, "dec_pp"), np.asarray(want),
                               atol=DEC_ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's one-card loss, global norm and clipped gradient."""
    cfg, params, _, mel, tokens, mask, _, _ = setup
    batch = TrainBatch(mel=jnp.asarray(mel),
                       tokens=jnp.asarray(tokens, jnp.int32),
                       loss_mask=jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn), static_argnums=1)(
        params, cfg, batch)
    norm = optax.global_norm(grads)
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(clipped)[0]}
    return float(loss), float(norm), flat


@pytest.mark.parametrize("axes", ranks.PP_TRAIN_MESHES,
                         ids=lambda a: "dp%d_sp%d_tp%d_pp%d" % a)
def test_train_step_pp_matches_one_card(setup, jax_step, axes):
    *_, out = setup
    loss, norm, grads = jax_step
    top = max(np.abs(g).max() for g in grads.values())
    pipeline = axes[3] > 1
    # the specs from the shapes alone (512 vocabulary rows split evenly)
    specs = dict(weights._keystr_leaves(param_pspecs(
        weights._unflatten({k: torch.empty(g.shape, device="meta")
                            for k, g in grads.items()}), pipeline=pipeline)))
    for r in range(ranks.WORLD):
        got_loss, got_norm, got = out[r]["train"][axes]
        assert abs(got_loss - loss) <= LOSS_RTOL * abs(loss)
        assert abs(got_norm - norm) <= LOSS_RTOL * abs(norm)
        for k, g in grads.items():
            want = ranks.block(g, specs[k], _axes(*axes), r)
            assert got[k].shape == want.shape, k
            np.testing.assert_allclose(got[k], want, rtol=0,
                                       atol=GRAD_SHARE * top, err_msg=k)
