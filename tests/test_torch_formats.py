"""The port's output formats (whisper_tpu_torch/formats.py) against the
JAX package's: the same segments and words give byte-equal strings."""

import json

import pytest

from whisper_tpu import formats as jax_formats
from whisper_tpu.alignment import WordTiming as JaxWord
from whisper_tpu_torch import formats
from whisper_tpu_torch.alignment import WordTiming

SEGS = [
    {"start": 0.0, "end": 2.5, "text": " Hello world."},
    {"start": 2.5, "end": 65.321, "text": " Second segment."},
    {"start": 65.4, "end": None, "text": " Open tail."},
    {"start": 3599.9995, "end": 3725.0004, "text": " Über ein Stündchen "},
    {"start": -0.2, "end": 0.0004, "text": "\tnegative start\n"},
]

WORDS = [(" a", 0.0, 0.2), (" b", 0.3, 0.5), (" c", 3.0, 3.2),
         (" déjà", 3.22, 3.5)] + [
    (" word" + str(i), 4 + i * 0.1, 4 + i * 0.1 + 0.05) for i in range(30)]


def _words(cls):
    return [cls(w, s, e, [i]) for i, (w, s, e) in enumerate(WORDS)]


@pytest.mark.parametrize("fmt", ["to_srt", "to_vtt", "to_tsv"])
@pytest.mark.parametrize("n", [0, 1, 3, len(SEGS)])
def test_segment_formats_equal_jax(fmt, n):
    got = getattr(formats, fmt)(SEGS[:n])
    assert got == getattr(jax_formats, fmt)(SEGS[:n])
    assert got.encode("utf-8") == getattr(jax_formats, fmt)(
        SEGS[:n]).encode("utf-8")


@pytest.mark.parametrize("segments,words,language", [
    (SEGS, True, "en"), (None, True, None), (SEGS, False, "de"),
    (None, False, None)])
def test_json_equal_jax(segments, words, language):
    got = formats.to_json("héllo", segments,
                          _words(WordTiming) if words else None,
                          language=language)
    want = jax_formats.to_json("héllo", segments,
                               _words(JaxWord) if words else None,
                               language=language)
    assert got == want
    doc = json.loads(got)
    assert ("words" in doc) == words


@pytest.mark.parametrize("gap,chars", [(0.8, 80), (10.0, 40), (0.05, 12),
                                       (0.8, 1)])
def test_words_to_segments_equal_jax(gap, chars):
    got = formats.words_to_segments(_words(WordTiming), max_gap_s=gap,
                                    max_len_chars=chars)
    want = jax_formats.words_to_segments(_words(JaxWord), max_gap_s=gap,
                                         max_len_chars=chars)
    assert got == want
    assert "".join(s["text"] for s in got) == "".join(w for w, _, _ in WORDS)
    assert formats.words_to_segments([]) == []


def test_srt_layout():
    out = formats.to_srt(SEGS[:3])
    assert "1\n00:00:00,000 --> 00:00:02,500\nHello world." in out
    assert "2\n00:00:02,500 --> 00:01:05,321\nSecond segment." in out
    assert "3\n00:01:05,400 --> 00:01:07,400\nOpen tail." in out
