"""The port's word alignment (whisper_tpu_torch/alignment.py) against the
JAX package's on the CPU at nano width: the cross-attention probabilities
(fp32, atol 1e-5), the median filter and the DTW path (exact, on the same
numpy matrix), word_timestamps end to end (words, tokens and times equal),
with and without a <|startofprev|> prompt, and the alignment-heads
sidecar."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import alignment as jax_alignment
from whisper_tpu.models.whisper import encoder_forward, init_params
from whisper_tpu.tokenizer import Tokenizer as JaxTokenizer
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch import alignment
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch.tokenizer import Tokenizer
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

PROBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def nano(small_cfg):
    """The nano weights (biases and LayerNorms perturbed), an encoder
    output from a seeded mel, both packages' trees and tokenizers."""
    cfg = small_cfg
    tcfg = tconfig.get_config("tiny").replace(
        name=cfg.name, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_audio_layers=cfg.n_audio_layers, n_text_layers=cfg.n_text_layers,
        n_audio_ctx=cfg.n_audio_ctx, n_text_ctx=cfg.n_text_ctx)
    rng = np.random.RandomState(11)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    mel = np.random.RandomState(1).randn(
        1, cfg.n_mels, cfg.n_frames).astype(np.float32) * 0.5
    enc = encoder_forward(jparams, cfg, jnp.asarray(mel))
    tparams = to_device(from_jax_params(tree), "cpu")
    return (cfg, tcfg, jparams, tparams, enc,
            torch.from_numpy(np.array(enc)),
            JaxTokenizer(config=cfg), Tokenizer(config=tcfg))


@pytest.mark.parametrize("text", [" hello brave new world",
                                  " a", " the quick brown fox jumps"])
def test_cross_attention_weights_match_jax(nano, text):
    cfg, tcfg, jp, tp, enc, tenc, jtok, _ = nano
    toks = build_prompt(cfg) + jtok.encode_greedy(text) + [cfg.eot_token]
    want = np.asarray(jax_alignment.cross_attention_weights(
        jp, cfg, jnp.asarray([toks], jnp.int32), enc))
    got = alignment.cross_attention_weights(tp, tcfg, torch.tensor([toks]),
                                            tenc)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (cfg.n_text_layers, 1, cfg.n_heads,
                                len(toks), cfg.n_audio_ctx)
    np.testing.assert_allclose(got.numpy(), want, atol=PROBS_ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_cross_attention_weights_batch_rows(nano):
    """Two rows at once equal each row alone (JAX's (B, T) contract)."""
    cfg, tcfg, jp, tp, enc, tenc, jtok, _ = nano
    a = build_prompt(cfg) + jtok.encode_greedy(" one two") + [cfg.eot_token]
    b = build_prompt(cfg) + jtok.encode_greedy(" three four") + [
        cfg.eot_token]
    both = alignment.cross_attention_weights(
        tp, tcfg, torch.tensor([a, b]), tenc.expand(2, -1, -1))
    want = np.asarray(jax_alignment.cross_attention_weights(
        jp, cfg, jnp.asarray([a, b], jnp.int32), jnp.tile(enc, (2, 1, 1))))
    np.testing.assert_allclose(both.numpy(), want, atol=PROBS_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 50), (3, 4, 33), (1, 7), (5, 1)])
@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter_equals_jax(shape, width):
    x = np.random.RandomState(sum(shape) + width).randn(*shape)
    np.testing.assert_array_equal(alignment.median_filter(x, width),
                                  jax_alignment.median_filter(x, width))


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (13, 7),
                                   (23, 57), (40, 40), (60, 700)])
def test_dtw_path_equals_jax(shape):
    """The same matrix, random and with ties (rounded values), gives the
    same path."""
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    for cost in (rng.rand(*shape), np.round(rng.rand(*shape), 1)):
        ti, tj = alignment.dtw_path(cost)
        wi, wj = jax_alignment.dtw_path(cost)
        np.testing.assert_array_equal(ti, wi)
        np.testing.assert_array_equal(tj, wj)


def _timings(words):
    return [(w.word, w.start, w.end, list(w.tokens)) for w in words]


@pytest.mark.parametrize("text,seconds", [
    (" hello brave new world", 10.0), (" the quick brown fox jumps over",
                                       30.0), (" one", 1.0)])
def test_word_timestamps_match_jax(nano, text, seconds):
    cfg, tcfg, jp, tp, enc, tenc, jtok, ttok = nano
    toks = build_prompt(cfg) + jtok.encode_greedy(text) + [cfg.eot_token]
    want = jax_alignment.word_timestamps(jp, cfg, jtok, toks, enc,
                                         audio_seconds=seconds)
    got = alignment.word_timestamps(tp, tcfg, ttok, toks, tenc,
                                    audio_seconds=seconds)
    assert _timings(got) == _timings(want)
    assert "".join(w.word for w in got) == text
    assert all(0.0 <= w.start <= w.end <= seconds + 0.05 for w in got)


def test_word_timestamps_prompt_len_skips_prev_text(nano):
    """Text tokens inside a <|startofprev|> prompt are not aligned when
    prompt_len covers them (tests/test_alignment.py:60), and are when it
    does not: both as in JAX."""
    cfg, tcfg, jp, tp, enc, tenc, jtok, ttok = nano
    prev = jtok.encode_greedy(" previous window text")
    gen = jtok.encode_greedy(" actual output")
    prompt = build_prompt(cfg, prev_tokens=prev)
    toks = prompt + gen + [cfg.eot_token]
    for plen in (len(prompt), 0):
        want = jax_alignment.word_timestamps(jp, cfg, jtok, toks, enc,
                                             audio_seconds=5.0,
                                             prompt_len=plen)
        got = alignment.word_timestamps(tp, tcfg, ttok, toks, tenc,
                                        audio_seconds=5.0, prompt_len=plen)
        assert _timings(got) == _timings(want)
    assert "".join(w.word for w in alignment.word_timestamps(
        tp, tcfg, ttok, toks, tenc, audio_seconds=5.0,
        prompt_len=len(prompt))) == " actual output"


def test_word_timestamps_explicit_heads_and_no_text(nano):
    cfg, tcfg, jp, tp, enc, tenc, jtok, ttok = nano
    toks = build_prompt(cfg) + jtok.encode_greedy(" red green blue") + [
        cfg.eot_token]
    heads = [(0, 1), (1, 0)]
    want = jax_alignment.word_timestamps(jp, cfg, jtok, toks, enc,
                                         audio_seconds=8.0,
                                         alignment_heads=heads,
                                         medfilt_width=3)
    got = alignment.word_timestamps(tp, tcfg, ttok, toks, tenc,
                                    audio_seconds=8.0, alignment_heads=heads,
                                    medfilt_width=3)
    assert _timings(got) == _timings(want)
    only_specials = build_prompt(cfg) + [cfg.eot_token]
    assert alignment.word_timestamps(tp, tcfg, ttok, only_specials,
                                     tenc) == []


@pytest.mark.parametrize("name,payload", [
    ("alignment_heads.json", [[2, 0], [3, 5]]),
    ("generation_config.json", {"alignment_heads": [[1, 1], [2, 3]],
                                "max_length": 448}),
    ("generation_config.json", {"max_length": 448}),
])
def test_alignment_heads_sidecar_equals_jax(tmp_path, name, payload):
    (tmp_path / name).write_text(json.dumps(payload))
    weights = str(tmp_path / "w.npz")
    assert alignment.find_alignment_heads(weights) == \
        jax_alignment.find_alignment_heads(weights)
    if isinstance(payload, list) or "alignment_heads" in payload:
        assert alignment.load_alignment_heads(str(tmp_path / name)) == \
            jax_alignment.load_alignment_heads(str(tmp_path / name))
    else:
        with pytest.raises(ValueError, match="alignment_heads"):
            alignment.load_alignment_heads(str(tmp_path / name))
    assert alignment.find_alignment_heads(str(tmp_path / "x" / "w")) is None


def test_pipeline_reads_the_sidecar(nano, tmp_path, monkeypatch):
    """from_npz fills alignment_heads from the sidecar beside the file, as
    JAX's from_npz does; from_params takes it as an argument."""
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.weights import init_params, save_npz
    cfg, tcfg, _, tp, _, _, _, _ = nano
    monkeypatch.setitem(tconfig.CONFIGS, tcfg.name, tcfg)
    save_npz(str(tmp_path / "w.npz"), init_params(tcfg, 0))
    assert WhisperPipeline.from_npz(str(tmp_path / "w.npz"), tcfg.name,
                                    device="cpu").alignment_heads is None
    (tmp_path / "alignment_heads.json").write_text("[[1, 0], [1, 1]]")
    pipe = WhisperPipeline.from_npz(str(tmp_path / "w.npz"), tcfg.name,
                                    device="cpu")
    assert pipe.alignment_heads == [(1, 0), (1, 1)]
    assert WhisperPipeline.from_params(
        tp, tcfg, device="cpu",
        alignment_heads=[(0, 0)]).alignment_heads == [(0, 0)]
