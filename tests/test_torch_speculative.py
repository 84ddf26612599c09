"""The port's speculative decoding (whisper_tpu_torch/speculative.py)
against the port's greedy decoding and the JAX package's
speculative_decode on the CPU, the cases of tests/test_speculative.py:
tokens and lengths equal to both, no_speech_prob at atol 1e-5,
sum_logprobs at rtol/atol 1e-4, and the round statistics equal to JAX's.
Also the pair and k checks, spec_transcribe_window, the sq-normalized
bf16 case, a decode that ends at the last context position, and the
attention routes under "pallas"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import encoder_forward, init_params
from whisper_tpu.speculative import speculative_decode as jax_spec
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch.decode import greedy_decode
from whisper_tpu_torch.speculative import (
    spec_transcribe_window,
    speculative_decode,
)
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

DRAFT = dict(name="spec-draft-nano", d_model=48, n_heads=2,
             n_audio_layers=1, n_text_layers=1)


def _port_cfg(cfg):
    """The port's config of the same fields as a JAX config."""
    return tconfig.get_config("tiny").replace(
        name=cfg.name, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_audio_layers=cfg.n_audio_layers, n_text_layers=cfg.n_text_layers,
        n_audio_ctx=cfg.n_audio_ctx, n_text_ctx=cfg.n_text_ctx,
        compute_dtype=cfg.compute_dtype, self_kv_quant=cfg.self_kv_quant)


def _port(tree, dtype=None):
    return to_device(from_jax_params(jax.tree.map(np.asarray, tree)), "cpu",
                     dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair(small_cfg):
    """Target: the 2-layer d64 nano. Draft: a 1-layer d48 nano with the
    same token space. Two mel rows, both models' encoder outputs, and the
    prompt; the JAX and the port trees of both."""
    t_cfg = small_cfg
    d_cfg = small_cfg.replace(**DRAFT)
    t_params = init_params(t_cfg, jax.random.PRNGKey(0))
    d_params = init_params(d_cfg, jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    mel = jnp.asarray(rng.randn(2, 80, t_cfg.n_frames).astype(np.float32)
                      * 0.4)
    t_enc = encoder_forward(t_params, t_cfg, mel)
    d_enc = encoder_forward(d_params, d_cfg, mel)
    prompt = np.tile(build_prompt(t_cfg), (2, 1))
    return dict(t_cfg=t_cfg, d_cfg=d_cfg, t_params=t_params,
                d_params=d_params, t_enc=t_enc, d_enc=d_enc, prompt=prompt,
                mel=mel)


def _bias(cfg, ban_eot=True):
    b = np.zeros(cfg.vocab_size, np.float32)
    if ban_eot:
        b[cfg.eot_token] = -1e9
    return b


def _check(pair, d_params, d_cfg, d_enc, k, max_new, bias):
    """The port's speculative decode against the port's greedy and JAX's
    speculative decode; returns the port's stats."""
    t_cfg, prompt = pair["t_cfg"], pair["prompt"]
    tp, dp = _port(pair["t_params"]), _port(d_params)
    tt, td = _port_cfg(t_cfg), _port_cfg(d_cfg)
    tb = None if bias is None else torch.from_numpy(bias)
    tprompt = torch.from_numpy(prompt).long()
    ref = greedy_decode(tp, tt, _t(pair["t_enc"]), tprompt, max_new=max_new,
                        logit_bias=tb)
    got, stats = speculative_decode(tp, tt, dp, td, _t(pair["t_enc"]),
                                    _t(d_enc), tprompt, max_new=max_new, k=k,
                                    logit_bias=tb, return_stats=True)
    want, jstats = jax_spec(pair["t_params"], t_cfg, d_params, d_cfg,
                            pair["t_enc"], d_enc,
                            jnp.asarray(prompt, jnp.int32), max_new=max_new,
                            k=k, logit_bias=None if bias is None
                            else jnp.asarray(bias), return_stats=True)
    for other in (ref.tokens.numpy(), np.asarray(want.tokens)):
        np.testing.assert_array_equal(got.tokens.numpy(), other)
    for other in (ref.lengths.numpy(), np.asarray(want.lengths)):
        np.testing.assert_array_equal(got.lengths.numpy(), other)
    np.testing.assert_allclose(got.no_speech_prob.numpy(),
                               ref.no_speech_prob.numpy(), atol=1e-5)
    for other in (ref.sum_logprobs.numpy(), np.asarray(want.sum_logprobs)):
        np.testing.assert_allclose(got.sum_logprobs.numpy(), other,
                                   rtol=1e-4, atol=1e-4)
    assert stats["rounds"] == int(jstats["rounds"])
    assert stats["accepted_drafts"] == int(jstats["accepted_drafts"])
    return stats


def test_cross_seed_draft_matches_greedy(pair):
    _check(pair, pair["d_params"], pair["d_cfg"], pair["d_enc"], k=3,
           max_new=16, bias=_bias(pair["t_cfg"]))


def test_target_as_draft_matches_greedy(pair):
    """Perfect draft (the target itself): every window fully accepted."""
    _check(pair, pair["t_params"], pair["t_cfg"], pair["t_enc"], k=4,
           max_new=17, bias=_bias(pair["t_cfg"]))


def test_perfect_draft_round_count_is_minimal(pair):
    """With the target as its own draft every round is fully accepted, so
    the rounds are ceil(max_new / (k+1)) and every round filled the
    draft's d_k row (a hole there would cut acceptance from round 2)."""
    k, max_new = 4, 17
    stats = _check(pair, pair["t_params"], pair["t_cfg"], pair["t_enc"],
                   k=k, max_new=max_new, bias=_bias(pair["t_cfg"]))
    assert stats["rounds"] == -(-max_new // (k + 1)) == 4
    assert stats["accepted_drafts"] == stats["rounds"] * k
    assert stats["draft_fills"] == stats["rounds"]


def test_hostile_draft_matches_greedy(pair):
    """A draft with no predictive power degrades the rounds, never the
    tokens."""
    d_cfg = pair["d_cfg"]
    d_params = init_params(d_cfg, jax.random.PRNGKey(99))
    rng = np.random.RandomState(7)
    d_enc = encoder_forward(
        d_params, d_cfg,
        jnp.asarray(rng.randn(2, 80, d_cfg.n_frames).astype(np.float32)))
    _check(pair, d_params, d_cfg, d_enc, k=2, max_new=11,
           bias=_bias(pair["t_cfg"]))


def test_eot_path_matches_greedy(pair):
    """No EOT ban: rows may finish inside a round; lengths and the EOT
    padding still match greedy."""
    _check(pair, pair["d_params"], pair["d_cfg"], pair["d_enc"], k=3,
           max_new=16, bias=None)


def test_eot_path_finishing_rows(pair):
    """A bias that makes EOT likely after a few tokens: rows finish at
    different rounds, one while the other goes on."""
    bias = _bias(pair["t_cfg"], ban_eot=False)
    bias[pair["t_cfg"].eot_token] = 6.5
    _check(pair, pair["d_params"], pair["d_cfg"], pair["d_enc"], k=3,
           max_new=16, bias=bias)


@pytest.mark.parametrize("k,max_new", [(1, 9), (8, 13)])
def test_k1_and_wide_k(pair, k, max_new):
    _check(pair, pair["d_params"], pair["d_cfg"], pair["d_enc"], k=k,
           max_new=max_new, bias=_bias(pair["t_cfg"]))


def test_pair_mismatch_rejected(pair):
    t_cfg = tconfig.get_config("large-v3")   # 51,866 vocab, shifted tokens
    with pytest.raises(ValueError, match="vocab_size"):
        speculative_decode(None, t_cfg, None, _port_cfg(pair["t_cfg"]),
                           None, None, torch.zeros((1, 4), dtype=torch.long))


def test_k_validation(pair):
    tt, td = _port_cfg(pair["t_cfg"]), _port_cfg(pair["d_cfg"])
    with pytest.raises(ValueError, match="k must be"):
        speculative_decode(_port(pair["t_params"]), tt,
                           _port(pair["d_params"]), td, _t(pair["t_enc"]),
                           _t(pair["d_enc"]),
                           torch.from_numpy(pair["prompt"]).long(),
                           max_new=4, k=0)


def test_spec_transcribe_window_matches_pipeline(pair):
    """Pipeline level: the same tokens and text as the target pipeline's
    transcribe_window and as JAX's spec_transcribe_window."""
    from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
    from whisper_tpu.speculative import spec_transcribe_window as jax_window
    from whisper_tpu_torch.pipeline import WhisperPipeline

    t_cfg, d_cfg = pair["t_cfg"], pair["d_cfg"]
    audio = (np.random.RandomState(0).randn(16000) * 0.1).astype(np.float32)
    t = WhisperPipeline(_port_cfg(t_cfg),
                        from_jax_params(jax.tree.map(np.asarray,
                                                     pair["t_params"])),
                        device="cpu")
    d = WhisperPipeline(_port_cfg(d_cfg),
                        from_jax_params(jax.tree.map(np.asarray,
                                                     pair["d_params"])),
                        device="cpu")
    got = spec_transcribe_window(t, d, audio, max_new=8, k=3)
    ref = t.transcribe_window(audio, max_new=8)
    assert got.tokens == ref.tokens
    assert got.text == ref.text
    want = jax_window(JaxPipeline(t_cfg, pair["t_params"], quant="off"),
                      JaxPipeline(d_cfg, pair["d_params"], quant="off"),
                      audio, max_new=8, k=3)
    assert got.tokens == want.tokens
    assert got.text == want.text
    for key in ("draft_k", "verify_rounds", "accepted_drafts"):
        assert got.timings[key] == want.timings[key]


def test_sq_target_normalized_to_bf16_cache(pair):
    """A target config with self_kv_quant is decoded with it off: tokens
    equal greedy on the sq-off config (the port's and JAX's), and no int8
    cache is made."""
    t_cfg, d_cfg, prompt = pair["t_cfg"], pair["d_cfg"], pair["prompt"]
    t_bf = t_cfg.replace(compute_dtype="bfloat16", self_kv_quant=True)
    d_bf = d_cfg.replace(compute_dtype="bfloat16")
    cast = lambda p: jax.tree.map(  # noqa: E731
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, p)
    jt, jd = cast(pair["t_params"]), cast(pair["d_params"])
    t_enc = encoder_forward(jt, t_bf, pair["mel"])
    d_enc = encoder_forward(jd, d_bf, pair["mel"])
    bias = _bias(t_cfg)
    want = jax_spec(jt, t_bf, jd, d_bf, t_enc, d_enc,
                    jnp.asarray(prompt, jnp.int32), max_new=12, k=3,
                    logit_bias=jnp.asarray(bias))
    tp = _port(pair["t_params"], torch.bfloat16)
    dp = _port(pair["d_params"], torch.bfloat16)
    tt, td = _port_cfg(t_bf), _port_cfg(d_bf)
    tenc = torch.from_numpy(np.array(t_enc.astype(jnp.float32))).bfloat16()
    denc = torch.from_numpy(np.array(d_enc.astype(jnp.float32))).bfloat16()
    tprompt = torch.from_numpy(prompt).long()
    tb = torch.from_numpy(bias)
    ref = greedy_decode(tp, tt.replace(self_kv_quant=False), tenc, tprompt,
                        max_new=12, logit_bias=tb)
    got = speculative_decode(tp, tt, dp, td, tenc, denc, tprompt, max_new=12,
                             k=3, logit_bias=tb)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))


def test_decode_to_the_last_context_position(pair):
    """P + 1 + max_new = n_text_ctx: the last rounds draft fewer tokens so
    that no cache row past the context is written; the tokens are still
    greedy's."""
    t_cfg, d_cfg = pair["t_cfg"], pair["d_cfg"]
    cap = 40
    tt = _port_cfg(t_cfg).replace(n_text_ctx=cap)
    td = _port_cfg(d_cfg).replace(n_text_ctx=cap)
    tp, dp = _port(pair["t_params"]), _port(pair["d_params"])
    for params in (tp, dp):
        params["decoder"]["pos_emb"] = params["decoder"]["pos_emb"][:cap]
    prompt = torch.from_numpy(pair["prompt"]).long()
    max_new = cap - 1 - prompt.shape[1]
    tb = torch.from_numpy(_bias(t_cfg))
    ref = greedy_decode(tp, tt, _t(pair["t_enc"]), prompt, max_new=max_new,
                        logit_bias=tb)
    for k, dparams, dcfg, denc in ((4, dp, td, pair["d_enc"]),
                                   (4, tp, tt, pair["t_enc"]),
                                   (7, tp, tt, pair["t_enc"])):
        got = speculative_decode(tp, tt, dparams, dcfg, _t(pair["t_enc"]),
                                 _t(denc), prompt, max_new=max_new, k=k,
                                 logit_bias=tb)
        np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())


def test_pallas_routes_and_launch_counts(pair, monkeypatch):
    """Under attn_backend "pallas": both prefills' and every verify's
    reads go to flash_attention, every draft T==1 read to
    decode_attention_bh (the CPU runs their plain versions), with the
    counts the stats imply, and the tokens are greedy's under "pallas"."""
    from whisper_tpu_torch.ops import attention

    counts = {"flash": 0, "decode": 0}
    for name, key in (("flash_attention", "flash"),
                      ("decode_attention_bh", "decode")):
        real = getattr(attention, name)

        def counted(*a, _real=real, _key=key, **kw):
            counts[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(attention, name, counted)
    tt = _port_cfg(pair["t_cfg"]).replace(attn_backend="pallas")
    td = _port_cfg(pair["d_cfg"]).replace(attn_backend="pallas")
    tp, dp = _port(pair["t_params"]), _port(pair["d_params"])
    prompt = torch.from_numpy(pair["prompt"]).long()
    tb = torch.from_numpy(_bias(pair["t_cfg"]))
    k, max_new = 3, 14
    got, stats = speculative_decode(tp, tt, dp, td, _t(pair["t_enc"]),
                                    _t(pair["d_enc"]), prompt,
                                    max_new=max_new, k=k, logit_bias=tb,
                                    return_stats=True)
    Lt, Ld = tt.n_text_layers, td.n_text_layers
    assert counts["flash"] == 2 * (Lt + Ld) + 2 * Lt * stats["rounds"]
    assert counts["decode"] == 2 * Ld * (k * stats["rounds"]
                                         + stats["draft_fills"])
    ref = greedy_decode(tp, tt, _t(pair["t_enc"]), prompt, max_new=max_new,
                        logit_bias=tb)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
