"""The port's decode rules (whisper_tpu_torch/decode_rules.py), greedy
decoding with them, language detection and the pipeline's options, against
the JAX package on the CPU.

The JAX decode stages are jitted on the config: this file's nano config
has a name of its own, so no other test's traced stages are reused."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.decode import detect_language as jax_detect_language
from whisper_tpu.decode import transcribe_tokens as jax_transcribe_tokens
from whisper_tpu.decode_rules import DecodeOptions as JaxOptions
from whisper_tpu.decode_rules import apply_rules as jax_apply_rules
from whisper_tpu.decode_rules import non_speech_tokens as jax_non_speech
from whisper_tpu.models.whisper import init_params as jax_init_params
from whisper_tpu.tokenizer import Tokenizer as JaxTokenizer
from whisper_tpu.tokenizer import build_prompt
from whisper_tpu_torch.decode import beam_decode, detect_language, \
    greedy_decode, transcribe_tokens
from whisper_tpu_torch.decode_rules import DecodeOptions, apply_rules, \
    non_speech_tokens
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.tokenizer import Tokenizer
from whisper_tpu_torch.weights import from_jax_params, to_device

torch.set_num_threads(2)

CFG = get_config("tiny").replace(name="torch-rules-nano", d_model=64,
                                 n_heads=2, n_audio_layers=2, n_text_layers=2)

# option sets held to JAX, by name: (kwargs of both DecodeOptions)
_OPTS = {
    "blank": dict(suppress_blank=True),
    "suppress": dict(suppress_blank=True, suppress_tokens=(100, 200, 50257)),
    "no_blank": dict(suppress_blank=False, suppress_tokens=(7,)),
    "timestamps": dict(timestamps=True),
    "ts_no_cap": dict(timestamps=True, max_initial_timestamp_index=None,
                      suppress_tokens=(11, 13)),
}


def _rule_inputs(seed, B=6, total=24, P=4):
    """Logits with timestamp-heavy rows (rule 4 fires), and token buffers
    whose generated part mixes text, single and paired timestamps."""
    rng = np.random.RandomState(seed)
    V, ts0 = CFG.vocab_size, CFG.timestamp_begin
    logits = rng.randn(B, V).astype(np.float32) * 3
    logits[::2, ts0:] += 6.0
    tokens = np.full((B, total), CFG.eot_token, np.int32)
    tokens[:, :P] = build_prompt(CFG)[:P]
    gen = [[ts0 + 3, 440, 2068], [440, ts0 + 10], [ts0 + 4, ts0 + 9],
           [], [ts0 + 1, 300, ts0 + 20, ts0 + 20, 501], [12, 13]]
    for b, g in enumerate(gen[:B]):
        tokens[b, P:P + len(g)] = g
    pos = np.array([P + len(g) for g in gen[:B]], np.int32)
    return logits, tokens, pos, P


@pytest.mark.parametrize("name", sorted(_OPTS))
@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rules_matches_jax(name, ragged):
    """Exact: the rules add NEG or leave a logit as it is, in the same
    order on both sides; rule 4's log-softmax only decides which."""
    logits, tokens, pos, P = _rule_inputs(len(name) + ragged)
    kw = _OPTS[name]
    if ragged:      # every row at its own position and prompt length
        pos_arg, plen = pos, np.full_like(pos, P)
        plen[1] = pos[1]                 # row 1 is at its first pick
        jpos, jplen = jnp.asarray(pos_arg), jnp.asarray(plen)
        tpos, tplen = torch.from_numpy(pos_arg), torch.from_numpy(plen)
    else:           # one shared position, as the lockstep greedy loop
        jpos = tpos = int(pos[0])
        jplen = tplen = P
    want = jax_apply_rules(jnp.asarray(logits), jnp.asarray(tokens), jpos,
                           jplen, CFG, JaxOptions(**kw))
    got = apply_rules(torch.from_numpy(logits), torch.from_numpy(tokens),
                      tpos, tplen, CFG, DecodeOptions(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_rules_scalar_equals_filled_vector():
    logits, tokens, pos, P = _rule_inputs(9)
    opts = DecodeOptions(timestamps=True, suppress_tokens=(5,))
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tokens)
    a = apply_rules(lt, tt, 7, P, CFG, opts)
    b = apply_rules(lt, tt, torch.full((6,), 7), torch.full((6,), P), CFG,
                    opts)
    assert torch.equal(a, b)


def test_non_speech_tokens_match_jax():
    assert non_speech_tokens(CFG, Tokenizer(config=CFG)) == \
        jax_non_speech(CFG, JaxTokenizer(config=CFG))
    assert non_speech_tokens(CFG) == jax_non_speech(CFG)


@pytest.fixture(scope="module")
def nano():
    rng = np.random.RandomState(1)
    np_tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        jax_init_params(CFG, jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, np_tree),
            to_device(from_jax_params(np_tree), "cpu"))


def test_detect_language_matches_jax(nano):
    """(B, 99) probabilities to 1e-5: one fp32 decoder pass each, summed
    in other orders."""
    jparams, tparams = nano
    enc = np.random.RandomState(2).randn(3, CFG.n_audio_ctx, CFG.d_model
                                         ).astype(np.float32)
    want = np.asarray(jax_detect_language(jparams, CFG, jnp.asarray(enc)))
    got = detect_language(tparams, CFG, torch.from_numpy(enc))
    assert got.shape == (3, CFG.n_languages) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


def _mel(seed, B=2):
    from whisper_tpu_torch.audio import log_mel_spectrogram
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(B, CFG.n_samples)).astype(np.float32)
    return log_mel_spectrogram(torch.from_numpy(audio), CFG)


@pytest.mark.parametrize("name", ["suppress", "timestamps", "no_blank"])
def test_greedy_with_opts_matches_jax(nano, name):
    """Tokens and lengths equal to JAX transcribe_tokens with the same
    rules (max_new=13: a cap no other test decodes with)."""
    jparams, tparams = nano
    kw = _OPTS[name]
    mel = _mel(3)
    prompt = np.tile(build_prompt(CFG, timestamps=kw.get("timestamps",
                                                         False)), (2, 1))
    want = jax_transcribe_tokens(jparams, CFG, jnp.asarray(mel.numpy()),
                                 jnp.asarray(prompt, jnp.int32), max_new=13,
                                 opts=JaxOptions(**kw))
    got = transcribe_tokens(tparams, CFG, mel, torch.from_numpy(prompt),
                            max_new=13, opts=DecodeOptions(**kw))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    if "suppress_tokens" in kw:
        gen = got.tokens[:, prompt.shape[1]:]
        for t in kw["suppress_tokens"][:2]:
            assert not (gen == t).any()


@pytest.mark.parametrize("decode,match", [
    (greedy_decode, "Generator"),
    (functools.partial(beam_decode, beam_size=2), "beam"),
])
def test_greedy_refuses_strategies_not_ported(nano, decode, match):
    """The strategy combinations the JAX package refuses: sampling
    without a random stream, beam search with a temperature."""
    _, tparams = nano
    with pytest.raises(ValueError, match=match):
        decode(tparams, CFG, torch.zeros(1, CFG.n_audio_ctx, CFG.d_model),
               torch.tensor([build_prompt(CFG)]), max_new=2,
               opts=DecodeOptions(temperature=0.5))


def test_pipeline_make_options_and_timestamps(nano):
    """make_options builds the JAX pipeline's greedy rule stack; with
    timestamps the prompt drops <|notimestamps|> and the first pick is a
    timestamp or EOT."""
    _, tparams = nano
    pipe = WhisperPipeline(CFG, tparams, device="cpu")
    assert pipe.make_options() == DecodeOptions(suppress_blank=False)
    opts = pipe.make_options(timestamps=True, suppress_nonspeech=True)
    assert opts.timestamps and opts.suppress_blank
    assert opts.suppress_tokens == non_speech_tokens(CFG, pipe.tokenizer)
    audio = (0.1 * np.random.RandomState(4).randn(1, CFG.n_samples)
             ).astype(np.float32)
    res = pipe.transcribe_batch(audio, max_new=4, opts=opts)
    ids = res.tokens[0].tolist()
    assert CFG.no_timestamps_token not in ids[:3]
    assert ids[3] >= CFG.timestamp_begin or ids[3] == CFG.eot_token
