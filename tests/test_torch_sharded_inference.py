"""The port's sharded inference (whisper_tpu_torch/parallel/inference.py
and the tp/sp hooks of models/whisper.py) against the JAX package's
unsharded model: prefill logits at (dp, tp) = (4, 1), (1, 4), (2, 2) and
with sp = 2 (beside tp = 2 and beside dp = 2) within atol 2e-4 and rtol
1e-5; greedy and beam-2 tokens under decisive weights (the JAX tests'
tok_emb x 4) equal to JAX's unsharded ones; transcribe_batch at (2, 2)
against JAX's ShardedPipeline on one device; and the checks that raise.
One gloo world of 4 CPU processes runs every rank-side check
(tests/torch_mesh_ranks.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from whisper_tpu.config import get_config
from whisper_tpu.decode import beam_decode, greedy_decode
from whisper_tpu.models.whisper import (
    decoder_forward,
    encoder_forward,
    init_kv_cache,
    init_params,
    precompute_cross_kv,
)
from whisper_tpu.parallel.inference import ShardedPipeline as JaxSharded
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import weights
from whisper_tpu_torch.parallel import launch
from whisper_tpu_torch.parallel.inference import ShardedPipeline

WORLD_TIMEOUT_S = 300
LOGITS_ATOL, LOGITS_RTOL = 2e-4, 1e-5


def _prefill_logits(cfg, params, mel, prompt):
    enc = encoder_forward(params, cfg, mel)
    cross = precompute_cross_kv(params, cfg, enc)
    logits, _ = decoder_forward(params, cfg, prompt, jnp.int32(0),
                                init_kv_cache(cfg, mel.shape[0]), cross)
    return logits


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("tiny").replace(
        name="shard-nano", d_model=64, n_heads=4, n_audio_layers=2,
        n_text_layers=2, n_audio_ctx=1500, n_text_ctx=448)
    params = init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    mel = (rng.randn(4, cfg.n_mels, cfg.n_frames) * 0.5).astype(np.float32)
    prompt = np.tile(build_prompt(cfg), (4, 1)).astype(np.int32)
    ref = np.asarray(jax.jit(
        lambda p, m, pr: _prefill_logits(cfg, p, m, pr))(params, mel,
                                                         prompt))
    # decisive weights: margins of O(40) against reduction-order noise
    dec = dict(params["decoder"])
    dec["tok_emb"] = dec["tok_emb"] * 4.0
    decisive = dict(params, decoder=dec)
    rng = np.random.RandomState(11)
    dmel = (rng.randn(4, cfg.n_mels, cfg.n_frames) * 0.5).astype(np.float32)
    enc = np.asarray(jax.jit(lambda p, m: encoder_forward(p, cfg, m))(
        decisive, dmel))
    audio = (np.random.RandomState(1).randn(4, 16000) * 0.1).astype(
        np.float32)
    out = launch.run(
        "torch_mesh_ranks:inference_rank", ranks.WORLD,
        (jax.tree.map(np.asarray, params), mel, prompt.astype(np.int64),
         jax.tree.map(np.asarray, decisive), enc, prompt.astype(np.int64),
         audio), timeout=WORLD_TIMEOUT_S)
    return cfg, params, decisive, ref, enc, prompt, audio, out


@pytest.mark.parametrize("mesh", ranks.PREFILL_MESHES,
                         ids=lambda m: "dp%d_tp%d_sp%d" % m)
def test_sharded_prefill_logits_match_jax(setup, mesh):
    *_, ref, _, _, _, out = setup
    dp = mesh[0]
    step = ranks.WORLD // dp
    got = np.concatenate([out[r]["prefill"][mesh]
                          for r in range(0, ranks.WORLD, step)])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
    # every rank of one dp shard holds the same rows (tp and sp replicas)
    for r in range(ranks.WORLD):
        base = (r // step) * step
        np.testing.assert_array_equal(out[r]["prefill"][mesh],
                                      out[base]["prefill"][mesh])


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_greedy_tokens_equal_jax(setup, dp, tp):
    cfg, _, decisive, _, enc, prompt, _, out = setup
    want = greedy_decode(decisive, cfg, jnp.asarray(enc),
                         jnp.asarray(prompt), max_new=12)
    step = ranks.WORLD // dp
    tokens = np.concatenate([out[r]["greedy"][dp, tp][0]
                             for r in range(0, ranks.WORLD, step)])
    lengths = np.concatenate([out[r]["greedy"][dp, tp][1]
                              for r in range(0, ranks.WORLD, step)])
    np.testing.assert_array_equal(tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(lengths, np.asarray(want.lengths))


def test_beam_tokens_equal_jax(setup):
    cfg, _, decisive, _, enc, prompt, _, out = setup
    want = beam_decode(decisive, cfg, jnp.asarray(enc), jnp.asarray(prompt),
                       beam_size=2, max_new=8)
    tokens = np.concatenate([out[r]["beam"][2, 2][0] for r in (0, 2)])
    lengths = np.concatenate([out[r]["beam"][2, 2][1] for r in (0, 2)])
    np.testing.assert_array_equal(tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(lengths, np.asarray(want.lengths))


def test_transcribe_batch_matches_jax(setup):
    """ShardedPipeline at (2, 2): every rank returns the whole batch, equal
    to JAX's ShardedPipeline on one device."""
    cfg, _, decisive, _, _, _, audio, out = setup
    want = JaxSharded(decisive, cfg, dp=1, tp=1,
                      devices=jax.devices()[:1]).transcribe_batch(
        audio, max_new=5)
    for r in out:
        assert len(r["transcribe"]) == 4
        assert [row["tokens"] for row in r["transcribe"]] == \
            [row["tokens"] for row in want]
        assert [row["text"] for row in r["transcribe"]] == \
            [row["text"] for row in want]
        assert r["transcribe"][0]["tokens"][0] == cfg.sot_token


def test_tp_must_divide_heads(setup):
    cfg, params, *_ = setup
    with pytest.raises(ValueError, match="must divide"):
        ShardedPipeline(weights.from_jax_params(
            jax.tree.map(np.asarray, params)), cfg, dp=1, tp=3,
            device="cpu")


def test_fused_step_refused_under_tp(setup):
    cfg, params, *_ = setup
    with pytest.raises(ValueError, match="fused"):
        ShardedPipeline(weights.from_jax_params(
            jax.tree.map(np.asarray, params)),
            cfg.replace(fused_step=True), dp=1, tp=2, device="cpu")


def test_batch_must_divide_dp(setup):
    *_, out = setup
    assert all(r["dp_raises"] for r in out)
