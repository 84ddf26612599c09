"""The port's beam search (whisper_tpu_torch/decode.py: beam_decode,
_beam_gather_cache, _top_w, decode_from_encoder) against the JAX package's
beam_decode on the same converted weights, on the CPU at nano width, and
the pinned seed-7 tiny anchor.

Every JAX beam call here decodes max_new=15 (the quant case 18): caps no
other test jits nano beam search with (see test_greedy_matches_jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_pinned import HZ, PINNED, SEED

from whisper_tpu.config import get_config
from whisper_tpu.decode import _beam_gather_cache as jax_gather_cache
from whisper_tpu.decode import beam_decode as jax_beam_decode
from whisper_tpu.decode_rules import DecodeOptions as JaxOptions
from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import decode
from whisper_tpu_torch.audio import log_mel_spectrogram
from whisper_tpu_torch.decode import (
    _beam_gather_cache,
    _top_w,
    beam_decode,
    decode_from_encoder,
    greedy_decode,
    transcribe_tokens,
)
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.models.whisper import quantize_weights_wq
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)
MAX_NEW = 15
B = 2


def _eot_prone(np_tree, cfg):
    """The same weights with EOT's embedding row a mix of the two tokens
    the nano model repeats: EOT then ranks near the top, so beams of
    width >= 3 finish early, at different steps in the two rows, while
    greedy runs to its cap."""
    tree = jax.tree.map(np.copy, np_tree)
    emb = tree["decoder"]["tok_emb"]
    emb[cfg.eot_token] = 0.7 * emb[49966] + 0.5 * emb[30684]
    return tree


@pytest.fixture(scope="module")
def nano(small_cfg):
    cfg = small_cfg
    base = jax.tree.map(np.asarray,
                        jax_init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    enc = rng.randn(B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    enc[1] *= 3.0
    trees = {"base": base, "eot": _eot_prone(base, cfg)}
    return cfg, trees, {k: to_device(from_jax_params(t), "cpu")
                        for k, t in trees.items()}, enc


# (weights, options): no rules; timestamps + suppression with the
# Google-NMT penalty; early EOT with both rankings
VARIANTS = {
    "plain": ("base", {}),
    "rules_lp": ("base", dict(timestamps=True, suppress_blank=True,
                              suppress_tokens=(220, 30684),
                              length_penalty=1.0)),
    "eot": ("eot", dict(suppress_blank=False)),
    "eot_lp": ("eot", dict(suppress_blank=False, length_penalty=1.0)),
}


def _prompt(cfg, timestamps=False):
    return np.tile(build_prompt(cfg, timestamps=timestamps), (B, 1))


@pytest.mark.parametrize("W", [1, 3, 5])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_beam_matches_jax(nano, variant, W):
    """Tokens and lengths equal; sum_logprobs and no_speech_prob within
    1e-4 (fp32 log-softmax sums of logits that agree to 1e-4)."""
    cfg, trees, tparams, enc = nano
    weights, kw = VARIANTS[variant]
    prompt = _prompt(cfg, kw.get("timestamps", False))
    want = jax_beam_decode(jax.tree.map(jnp.asarray, trees[weights]), cfg,
                           jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
                           beam_size=W, max_new=MAX_NEW,
                           opts=JaxOptions(**kw) if kw else None)
    got = beam_decode(tparams[weights], cfg, torch.from_numpy(enc),
                      torch.from_numpy(prompt), beam_size=W, max_new=MAX_NEW,
                      opts=DecodeOptions(**kw) if kw else None)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.sum_logprobs.numpy(),
                               np.asarray(want.sum_logprobs), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(got.no_speech_prob.numpy(),
                               np.asarray(want.no_speech_prob), atol=1e-4)
    if variant.startswith("eot") and W > 1:
        # the case is what it says: the best beams ended before the cap
        assert (got.lengths < prompt.shape[1] + 1 + MAX_NEW).all()


@pytest.mark.parametrize("weights", ["base", "eot"])
def test_beam_one_equals_greedy(nano, weights):
    cfg, _, tparams, enc = nano
    args = (tparams[weights], cfg, torch.from_numpy(enc),
            torch.from_numpy(_prompt(cfg)))
    g = greedy_decode(*args, max_new=MAX_NEW)
    b = beam_decode(*args, beam_size=1, max_new=MAX_NEW)
    assert torch.equal(g.tokens, b.tokens)
    assert torch.equal(g.lengths, b.lengths)
    torch.testing.assert_close(b.sum_logprobs, g.sum_logprobs, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("W", [3, 5])
def test_best_beam_scores_at_least_greedy(nano, W):
    """With no beam ending early (the base weights: every beam runs to
    the cap, so the ranking compares sums), the best beam's logprob sum
    is at least the greedy path's: beam search explores a superset."""
    cfg, _, tparams, enc = nano
    args = (tparams["base"], cfg, torch.from_numpy(enc),
            torch.from_numpy(_prompt(cfg)))
    g = beam_decode(*args, beam_size=1, max_new=MAX_NEW)
    b = beam_decode(*args, beam_size=W, max_new=MAX_NEW)
    assert torch.equal(b.lengths, g.lengths)
    assert (b.sum_logprobs >= g.sum_logprobs - 1e-4).all()


def test_beam_rejects_temperature(nano):
    cfg, _, tparams, enc = nano
    with pytest.raises(ValueError, match="beam search is deterministic"):
        beam_decode(tparams["base"], cfg, torch.from_numpy(enc),
                    torch.from_numpy(_prompt(cfg)), beam_size=2, max_new=2,
                    opts=DecodeOptions(temperature=0.7))
    with pytest.raises(ValueError, match="logit_bias"):
        decode_from_encoder(tparams["base"], cfg, torch.from_numpy(enc),
                            torch.from_numpy(_prompt(cfg)), max_new=2,
                            beam_size=2,
                            logit_bias=torch.zeros(cfg.vocab_size))


def test_polling_matches_stepwise(nano, monkeypatch):
    """Polling for the early exit every N steps gives the step-wise loop's
    results: after every beam has finished, a step leaves the beams, their
    tokens and their scores where they were."""
    cfg, _, tparams, enc = nano
    runs = []
    for n in (1, 8):
        monkeypatch.setattr(decode, "POLL_EVERY", n)
        runs.append(beam_decode(tparams["eot"], cfg, torch.from_numpy(enc),
                                torch.from_numpy(_prompt(cfg)), beam_size=3,
                                max_new=MAX_NEW))
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].sum_logprobs, runs[1].sum_logprobs)


@pytest.mark.parametrize("layout", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("S,kv_len", [(64, 37), (448, 130), (448, 448)])
def test_cache_gather_matches_jax(layout, S, kv_len):
    """The gathered prefix equals JAX's _beam_gather_cache (the full take
    at S=64, the block loop at S=448); the port writes into the same
    tensors and leaves the columns past kv_len alone."""
    rng = np.random.RandomState(S + kv_len)
    L, BW, H, D = 2, 6, 2, 8
    if layout == "int8":
        cache = {"k": rng.randint(-127, 128, (L, BW, H, S, D)).astype(np.int8),
                 "k_s": rng.rand(L, BW, H, S, 1).astype(np.float32),
                 "v": rng.randint(-127, 128, (L, BW, H, S, D)).astype(np.int8),
                 "v_s": rng.rand(L, BW, H, S, 1).astype(np.float32)}
    else:
        cache = {n: rng.randn(L, BW, H, S, D).astype(np.float32)
                 for n in ("k", "v")}
    src = np.array([2, 2, 0, 5, 3, 3])
    want = jax_gather_cache({k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(src), kv_len, 3)
    dtype = torch.bfloat16 if layout == "bfloat16" else None
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    if dtype is not None:
        tcache = {k: v.to(dtype) for k, v in tcache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    _beam_gather_cache(tcache, torch.from_numpy(src), kv_len)
    for name, t in tcache.items():
        assert t.data_ptr() == ptrs[name]
        w = np.array(want[name])[:, :, :, :kv_len]
        if dtype is not None:
            w = torch.from_numpy(w).to(dtype).float().numpy()
        np.testing.assert_array_equal(t[:, :, :, :kv_len].float().numpy(),
                                      w.astype(np.float32), err_msg=name)
        assert torch.equal(t[:, :, :, kv_len:], before[name][:, :, :, kv_len:])


@pytest.mark.parametrize("case", ["ties", "neg_fill", "signed_zero"])
def test_top_w_order_is_jax_top_k(case):
    """Equal candidates come out lower index first, as jax.lax.top_k
    gives them, whatever torch.topk's own tie rule."""
    rng = np.random.RandomState(7)
    if case == "ties":
        x = rng.randint(-3, 3, (4, 40)).astype(np.float32) * 0.5
    elif case == "neg_fill":     # a frozen beam's row: EOT at sum_lp, NEG
        x = np.full((3, 3 * 50), -1e9, np.float32)
        x[:, [7, 57, 107]] = -4.25
        x[1, 57] = -3.0
    else:
        x = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, 1.0, -1.0, -1.0]],
                     np.float32)
    for w in (1, 3, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), w)
        got_v, got_i = _top_w(torch.from_numpy(x), w)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(np.signbit(got_v.numpy()),
                                      np.signbit(np.asarray(want_v)))


def test_beam_under_serving_quant_matches_jax(small_cfg):
    """Beam search over weight-only int8 and the int8 cross cache (bf16):
    the converted quantized tree decodes JAX's tokens; beam 1 equals
    greedy under the same quantized math."""
    from whisper_tpu.models.whisper import quantize_weights_wq as jax_wq
    from whisper_tpu.weights import to_device as jax_to_device

    cfg = small_cfg.replace(compute_dtype="bfloat16", weight_quant=True,
                            cross_kv_quant=True)
    jparams = jax_wq(jax_to_device(jax_init_params(cfg, jax.random.PRNGKey(3)),
                                   jnp.bfloat16), cfg)
    tparams = quantize_weights_wq(to_device(from_jax_params(jax.tree.map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(3)))), "cpu",
        torch.bfloat16), cfg)
    enc = np.random.RandomState(4).randn(1, cfg.n_audio_ctx, cfg.d_model
                                         ).astype(np.float32)
    prompt = np.asarray([build_prompt(cfg)])
    want = jax_beam_decode(jparams, cfg, jnp.asarray(enc, jnp.bfloat16),
                           jnp.asarray(prompt, jnp.int32), beam_size=3,
                           max_new=18)
    args = (tparams, cfg, torch.from_numpy(enc).to(torch.bfloat16),
            torch.from_numpy(prompt))
    got = beam_decode(*args, beam_size=3, max_new=18)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.sum_logprobs.numpy(),
                               np.asarray(want.sum_logprobs), atol=1e-2,
                               rtol=1e-3)
    g = greedy_decode(*args, max_new=18)
    b1 = beam_decode(*args, beam_size=1, max_new=18)
    assert torch.equal(g.tokens, b1.tokens)


def test_pinned_beam3_through_port():
    """The JAX package's seed-7 tiny weights, converted, reproduce
    PINNED["beam3"] through the port's transcribe_tokens (fp32, CPU)."""
    cfg = get_config("tiny")
    params = to_device(from_jax_params(jax.tree.map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(SEED)))), "cpu")
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    audio = (0.4 * np.sin(2 * np.pi * HZ * t)).astype(np.float32)
    mel = log_mel_spectrogram(torch.from_numpy(audio)[None], cfg)
    res = transcribe_tokens(params, cfg, mel,
                            torch.tensor([build_prompt(cfg)]), max_new=12,
                            opts=DecodeOptions(beam_size=3), beam_size=3)
    assert res.tokens[0, :int(res.lengths[0])].tolist() == PINNED["beam3"]
