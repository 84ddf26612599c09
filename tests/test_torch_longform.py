"""The port's long-form layer against the JAX package on the CPU:
WhisperPipeline.transcribe over 70 s of audio (fixed 30 s windows,
timestamps with seek, condition_on_previous, initial_prompt, the VAD gate
over a silent middle window, word timestamps), the seek arithmetic on
canned windows (the cases of tests/test_seek.py), and audio.energy_vad.

Everything runs in fp32 at nano width: tokens, text, segments and words
must be equal, with no tolerance (the segment and word times are sums of
the same frame counts and offsets)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import audio as jax_audio
from whisper_tpu import pipeline as jax_pipeline
from whisper_tpu.models.whisper import init_params
from whisper_tpu_torch import audio as port_audio
from whisper_tpu_torch import config as tconfig
from whisper_tpu_torch import pipeline
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SR = 16_000
MAX_NEW = 8


@pytest.fixture(scope="module")
def pipes(small_cfg):
    """The JAX and the port pipeline on the same nano weights (fp32, quant
    off), the biases and LayerNorms perturbed so that no layer is an
    identity."""
    cfg = small_cfg.replace(name="torch-longform-nano")
    rng = np.random.RandomState(5)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))
                   ).astype(np.float32),
        init_params(cfg, jax.random.PRNGKey(0)))
    jpipe = jax_pipeline.WhisperPipeline(
        cfg, jax.tree.map(jnp.asarray, tree), quant="off")
    tpipe = pipeline.WhisperPipeline(cfg, from_jax_params(tree),
                                     device="cpu")
    return cfg, jpipe, tpipe


def _clip(seconds: float, seed: int, silent=()) -> np.ndarray:
    """Seeded tones plus noise; each (start_s, end_s) of `silent` zeroed."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * (220 + 40 * np.floor(t / 7)) * t)
         + 0.05 * rng.randn(t.size)).astype(np.float32)
    for a, b in silent:
        x[int(a * SR):int(b * SR)] = 0.0
    return x


AUDIO_70 = _clip(70.0, 0, silent=[(30.0, 60.0)])

MODES = {
    "fixed": dict(),
    "timestamps_seek": dict(timestamps=True),
    "condition_on_previous": dict(condition_on_previous=True),
    "initial_prompt": dict(initial_prompt=" the quick brown fox"),
    "vad_silent_middle": dict(vad_threshold_db=-40.0),
    "word_timestamps": dict(word_timestamps=True, timestamps=True,
                            condition_on_previous=True),
}


def _words(words):
    return None if words is None else [
        (w.word, w.start, w.end, list(w.tokens)) for w in words]


@pytest.mark.parametrize("mode", list(MODES))
def test_transcribe_matches_jax(pipes, mode):
    cfg, jpipe, tpipe = pipes
    kw = dict(MODES[mode])
    ts = kw.pop("timestamps", False)
    want = jpipe.transcribe(AUDIO_70, max_new=MAX_NEW,
                            opts=jpipe.make_options(timestamps=True)
                            if ts else None, **kw)
    got = tpipe.transcribe(AUDIO_70, max_new=MAX_NEW,
                           opts=tpipe.make_options(timestamps=True)
                           if ts else None, **kw)
    assert got.tokens == want.tokens
    assert got.text == want.text
    assert got.segments == want.segments
    assert _words(got.words) == _words(want.words)
    assert set(got.timings) == set(want.timings)
    windows = got.tokens.count(cfg.sot_token)
    if mode == "vad_silent_middle":
        assert windows == 2                 # the 30-60 s window skipped
    elif mode == "timestamps_seek":
        assert got.segments                 # seek read a closed segment
    else:
        assert windows == 3
    if mode == "word_timestamps":
        assert got.words and all(
            0.0 <= w.start <= w.end <= 70.0 + 0.05 for w in got.words)


def test_initial_prompt_conditions_every_window(pipes, monkeypatch):
    """initial_prompt reaches the windows' prompts through
    <|startofprev|>; without condition_on_previous nothing replaces it, so
    every window gets it, as in JAX. The prompts asked for equal JAX's."""
    cfg, jpipe, tpipe = pipes
    seen = {"jax": [], "port": []}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        real = pipe.transcribe_window

        def spy(*a, _real=real, _log=seen[name], **kw):
            _log.append(tuple(kw["prev_tokens"]))
            return _real(*a, **kw)
        monkeypatch.setattr(pipe, "transcribe_window", spy)
        pipe.transcribe(AUDIO_70[:45 * SR], max_new=4,
                        initial_prompt=" hello there")
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 2
    assert seen["port"][0] and seen["port"][1] == seen["port"][0]


# ---- seek arithmetic on canned windows (tests/test_seek.py) ----

class _FakePipe(pipeline.WhisperPipeline):
    """transcribe_window replaced by canned segment endings, so that the
    seek arithmetic is tested alone."""

    def __init__(self, cfg, endings):
        self.cfg = cfg
        self.params = None
        self.tokenizer = None
        self._endings = list(endings)
        self.offsets: list[float] = []

    def transcribe_window(self, audio, language="en", task="transcribe",
                          max_new=None, opts=None, prev_tokens=(),
                          seed=0, fallback_temperatures=(),
                          no_speech_threshold=None, word_timestamps=False,
                          window_offset_s=0.0):
        self.offsets.append(window_offset_s)
        end = self._endings.pop(0) if self._endings else None
        return pipeline.Transcription(
            text="x", tokens=[50258],
            timings={"mel_s": 0, "decode_s": 0, "detok_s": 0, "total_s": 0},
            segments=[{"start": window_offset_s, "end": end, "text": "x"}])


def test_seek_advances_by_last_closed_segment():
    pipe = _FakePipe(tconfig.get_config("tiny"), endings=[17.5, 40.0, None])
    r = pipe.transcribe(np.zeros(70 * SR, np.float32),
                        opts=DecodeOptions(timestamps=True))
    assert pipe.offsets[0] == 0.0
    assert abs(pipe.offsets[1] - 17.5) < 1e-6
    assert abs(pipe.offsets[2] - 40.0) < 1e-6
    assert len(r.segments) == 3


def test_seek_fixed_windows_without_timestamps():
    pipe = _FakePipe(tconfig.get_config("tiny"), endings=[17.5, 40.0, None])
    pipe.transcribe(np.zeros(70 * SR, np.float32))
    assert pipe.offsets == [0.0, 30.0, 60.0]


def test_seek_minimum_progress_guard():
    pipe = _FakePipe(tconfig.get_config("tiny"),
                     endings=[0.0, 0.5, None, None])
    pipe.transcribe(np.zeros(40 * SR, np.float32),
                    opts=DecodeOptions(timestamps=True))
    assert (np.diff(pipe.offsets) >= 0.999).all()


@pytest.mark.parametrize("endings,seconds", [
    ([17.5, 40.0, None], 70), ([29.99, 31.0, 45.5], 50), ([None], 10)])
def test_seek_offsets_equal_jax(endings, seconds):
    """The same canned windows through both packages' transcribe give the
    same window offsets and segments."""
    from whisper_tpu.config import get_config
    from whisper_tpu.decode_rules import DecodeOptions as JaxOptions

    class _JaxFake(jax_pipeline.WhisperPipeline):
        __init__ = _FakePipe.__init__

        def transcribe_window(self, *a, window_offset_s=0.0, **kw):
            self.offsets.append(window_offset_s)
            end = self._endings.pop(0) if self._endings else None
            return jax_pipeline.Transcription(
                text="x", tokens=[50258],
                timings={"mel_s": 0, "decode_s": 0, "detok_s": 0,
                         "total_s": 0},
                segments=[{"start": window_offset_s, "end": end,
                           "text": "x"}])

    audio = np.zeros(seconds * SR, np.float32)
    jp = _JaxFake(get_config("tiny"), endings)
    tp = _FakePipe(tconfig.get_config("tiny"), endings)
    want = jp.transcribe(audio, opts=JaxOptions(timestamps=True))
    got = tp.transcribe(audio, opts=DecodeOptions(timestamps=True))
    assert tp.offsets == jp.offsets
    assert got.segments == want.segments


# ---- energy_vad (whisper_tpu/audio.py:166) ----

VAD_CLIPS = {
    "silent": np.zeros(SR * 3, np.float32),
    "loud": _clip(3.0, 1),
    "quiet_noise": (np.random.RandomState(2).randn(SR * 3) * 1e-3
                    ).astype(np.float32),
    "short_loud_tail": _clip(0.05, 3),       # one 30 ms frame and a bit
    "tiny_tail": _clip(0.01, 4),             # shorter than one frame
    "empty": np.zeros(0, np.float32),
    "burst": np.concatenate([np.zeros(SR, np.float32), _clip(0.07, 5),
                             np.zeros(SR, np.float32)]),
}


@pytest.mark.parametrize("threshold_db", [-60.0, -40.0, -20.0, -5.0])
@pytest.mark.parametrize("clip", list(VAD_CLIPS))
def test_energy_vad_matches_jax(clip, threshold_db):
    x = VAD_CLIPS[clip]
    want = jax_audio.energy_vad(x, SR, threshold_db=threshold_db)
    got = port_audio.energy_vad(x, SR, threshold_db=threshold_db)
    assert got is want or got == want
    assert isinstance(got, bool)


def test_energy_vad_min_frames_and_frame_ms_match_jax():
    x = VAD_CLIPS["burst"]
    for frame_ms in (10.0, 30.0, 100.0):
        for need in (1, 3, 8):
            assert port_audio.energy_vad(
                x, SR, frame_ms=frame_ms, min_speech_frames=need) == \
                jax_audio.energy_vad(x, SR, frame_ms=frame_ms,
                                     min_speech_frames=need)
