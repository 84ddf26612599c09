"""The port's own config and tokenizer (whisper_tpu_torch/config.py,
tokenizer.py, assets/vocab.txt) against the JAX package's, on the CPU:
the same table of models, field for field, the same vocabulary file byte
for byte, and the same ids, texts, prompts and errors."""

import dataclasses
import filecmp

import numpy as np
import pytest

from whisper_tpu import config as jax_config
from whisper_tpu import tokenizer as jax_tok
from whisper_tpu_torch import config as port_config
from whisper_tpu_torch import tokenizer as port_tok


@pytest.mark.parametrize("name", sorted(jax_config.CONFIGS))
def test_configs_equal_field_for_field(name):
    jc = jax_config.get_config(name)
    pc = port_config.get_config(name)
    jf = [f.name for f in dataclasses.fields(jc)]
    assert [f.name for f in dataclasses.fields(pc)] == jf
    for field in jf:
        assert getattr(pc, field) == getattr(jc, field), field
    for prop in ("head_dim", "n_frames", "eot_token", "sot_token",
                 "sot_prev_token", "no_speech_token", "timestamp_begin",
                 "transcribe_token", "translate_token",
                 "no_timestamps_token", "first_language_token",
                 "multilingual", "max_new_tokens"):
        assert getattr(pc, prop) == getattr(jc, prop), prop


def test_config_table_aliases_and_replace_agree():
    assert sorted(port_config.CONFIGS) == sorted(jax_config.CONFIGS)
    for alias in ("large", "turbo"):
        assert port_config.get_config(alias) == \
            port_config.get_config(jax_config.get_config(alias).name)
    pc = port_config.get_config("tiny").replace(d_model=64, n_heads=2)
    jc = jax_config.get_config("tiny").replace(d_model=64, n_heads=2)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    with pytest.raises(ValueError) as pe:
        port_config.get_config("no-such-model")
    with pytest.raises(ValueError) as je:
        jax_config.get_config("no-such-model")
    assert str(pe.value) == str(je.value)


def test_bundled_vocab_is_a_byte_identical_copy():
    assert port_tok._ASSET_VOCAB != jax_tok._ASSET_VOCAB
    assert filecmp.cmp(port_tok._ASSET_VOCAB, jax_tok._ASSET_VOCAB,
                       shallow=False)


@pytest.fixture(scope="module")
def tokenizers():
    return (port_tok.Tokenizer(config=port_config.get_config("tiny")),
            jax_tok.Tokenizer(config=jax_config.get_config("tiny")))


_TEXTS = ["Hello world.", " the quick brown fox", "naïve café — 東京",
          "I'm 42! ... \"quoted\"\nnext line", ""]


def test_decode_encode_agree(tokenizers):
    pt, jt = tokenizers
    assert pt.vocab_size == jt.vocab_size == 51_865
    rng = np.random.RandomState(0)
    samples = [rng.randint(0, 51_865, size=n).tolist() for n in (1, 7, 40)]
    samples += [[50258, 50259, 50359, 50363, 440, 2068, 50257],
                [50364, 1012, 50414, 50257]]
    for ids in samples:
        assert pt.decode(ids) == jt.decode(ids)
        assert pt.decode(ids, skip_special=False) == \
            jt.decode(ids, skip_special=False)
        assert pt.decode_reference(ids) == jt.decode_reference(ids)
    for text in _TEXTS:
        assert pt.encode(text) == jt.encode(text)
        assert pt.encode_greedy(text) == jt.encode_greedy(text)


@pytest.mark.parametrize("model", ["tiny", "tiny.en", "large-v3-turbo"])
def test_build_prompt_agrees(model):
    pc, jc = port_config.get_config(model), jax_config.get_config(model)
    langs = ("en", "de", "ja") if pc.multilingual else ("en",)
    for language in langs:
        for task in ("transcribe", "translate"):
            for timestamps in (False, True):
                for prev in ((), (1000, 1001, 1002), tuple(range(300, 420))):
                    kw = dict(timestamps=timestamps, prev_tokens=prev)
                    assert port_tok.build_prompt(pc, language, task, **kw) \
                        == jax_tok.build_prompt(jc, language, task, **kw)
    # the prompts tests/test_golden_pinned.py builds
    for timestamps in (False, True):
        assert port_tok.build_prompt(pc, timestamps=timestamps) == \
            jax_tok.build_prompt(jc, timestamps=timestamps)
    assert port_tok.LANGUAGES == jax_tok.LANGUAGES
    assert port_tok.language_token(pc, "fr") == \
        jax_tok.language_token(jc, "fr")


def test_split_segments_agrees(tokenizers):
    pt, jt = tokenizers
    pc, jc = port_config.get_config("tiny"), jax_config.get_config("tiny")
    ts0 = pc.timestamp_begin
    ids = [ts0, 440, 2068, ts0 + 25, ts0 + 25, 1012, ts0 + 60, 50257]
    for offset in (0.0, 30.0):
        assert port_tok.split_segments(pc, ids, pt, offset) == \
            jax_tok.split_segments(jc, ids, jt, offset)


def test_v3_model_without_vocab_path_raises_the_same():
    """The bundled 51,865-entry table is one short of a 51,866-token
    model; both packages refuse it with the same message, each naming
    its own copy of the table."""
    pc = port_config.get_config("large-v3-turbo")
    jc = jax_config.get_config("large-v3-turbo")
    with pytest.raises(ValueError, match="vocab_path") as pe:
        port_tok.Tokenizer(config=pc)
    with pytest.raises(ValueError, match="vocab_path") as je:
        jax_tok.Tokenizer(config=jc)
    assert str(pe.value).replace(port_tok._ASSET_VOCAB, "<table>") == \
        str(je.value).replace(jax_tok._ASSET_VOCAB, "<table>")
