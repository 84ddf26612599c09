"""Port log-mel frontend (whisper_tpu_torch/audio.py) against the JAX
frontend and transformers' WhisperFeatureExtractor on 30 s clips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.audio import _frontend_constants as jax_constants
from whisper_tpu.audio import log_mel_spectrogram as jax_log_mel
from whisper_tpu.config import get_config
from whisper_tpu_torch.audio import _frontend_constants, log_mel_spectrogram

torch.set_num_threads(2)


def test_constants_match_jax():
    cfg = get_config("tiny")
    args = (cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.hop_length)
    for got, want in zip(_frontend_constants(*args), jax_constants(*args)):
        np.testing.assert_array_equal(got, want)


def test_log_mel_matches_jax_30s():
    """atol 1e-4 on values of order 1: both sides are fp32 matmuls over a
    400-sample frame and 201 bins, summed in different orders."""
    cfg = get_config("tiny")
    rng = np.random.RandomState(0)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    audio = np.stack([0.3 * np.sin(2 * np.pi * 220 * t)
                      + 0.05 * rng.randn(cfg.n_samples),
                      0.5 * rng.randn(cfg.n_samples)]).astype(np.float32)
    want = np.asarray(jax_log_mel(jnp.asarray(audio), cfg))
    got = log_mel_spectrogram(torch.from_numpy(audio), cfg)
    assert got.shape == (2, cfg.n_mels, cfg.n_frames) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_log_mel_single_clip_1d():
    cfg = get_config("tiny")
    audio = np.zeros(cfg.n_samples, np.float32)
    audio[:16000] = 0.1
    got = log_mel_spectrogram(torch.from_numpy(audio), cfg)
    assert got.shape == (1, cfg.n_mels, cfg.n_frames)
    assert torch.isfinite(got).all()


def test_log_mel_matches_transformers_feature_extractor():
    """The contract the reference's mel input was produced under
    (transformers.WhisperFeatureExtractor): 1e-4 on 30 s of two tones and
    noise, as tests/test_audio.py holds the JAX frontend."""
    transformers = pytest.importorskip("transformers")
    cfg = get_config("tiny")
    rng = np.random.RandomState(0)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    audio = (0.5 * np.sin(2 * np.pi * 440 * t)
             + 0.25 * np.sin(2 * np.pi * 1337 * t + 0.3)
             + 0.05 * rng.randn(cfg.n_samples)).astype(np.float32)
    fe = transformers.WhisperFeatureExtractor(feature_size=cfg.n_mels)
    ref = fe(audio, sampling_rate=cfg.sample_rate,
             return_tensors="np").input_features[0]
    got = log_mel_spectrogram(torch.from_numpy(audio), cfg)[0].numpy()
    assert np.abs(ref - got).max() < 1e-4
