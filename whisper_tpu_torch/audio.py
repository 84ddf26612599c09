"""Log-mel audio frontend (whisper_tpu/audio.py:112 log_mel_spectrogram).

The numpy constants (periodic Hann window, the hop-padded DFT basis and
the Slaney mel filterbank, whisper_tpu/audio.py:36-110) are rebuilt here
because the JAX module imports jax. The STFT is the same single matmul:
the reflect-padded signal is cut into hop chunks, each frame is n_span
consecutive chunks, and the frames meet the zero-tail-padded DFT basis in
one (B*frames, span) x (span, 2F) product. Then the power spectrum, the
mel projection, log10 clamped at 1e-10, the per-sample max-8 clamp,
(x+4)/4, and the last frame dropped (3001 -> 3000).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from whisper_tpu.config import WhisperConfig
from whisper_tpu_torch.models.whisper import full_fp32


def hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= 1000.0,
                    15.0 + np.log(np.maximum(freq, 1000.0) / 1000.0) * logstep,
                    mels)


def mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= 15.0,
                    1000.0 * np.exp(logstep * (np.maximum(mels, 15.0) - 15.0)),
                    freq)


def mel_filter_bank(n_freqs: int, n_mels: int, sample_rate: int,
                    f_min: float = 0.0, f_max: float = 8000.0) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, (n_mels, n_freqs)."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hertz_to_mel_slaney(np.array(f_min)),
                          hertz_to_mel_slaney(np.array(f_max)), n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb = fb * (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _frontend_constants(n_fft: int, n_mels: int, sample_rate: int,
                        hop_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(dft_kernel (2*n_freqs, n_span*hop), mel_fb (n_mels, n_freqs)).
    Row i < n_freqs of the DFT basis is window*cos(2*pi*i*n/N), row
    n_freqs+i is -window*sin(...), zero beyond n_fft. Read-only arrays:
    the cache hands the same ones to every caller."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))   # periodic Hann
    ang = 2.0 * np.pi * np.outer(np.arange(n_freqs), n) / n_fft
    dft = np.concatenate([np.cos(ang) * window[None, :],
                          -np.sin(ang) * window[None, :]]).astype(np.float32)
    span = -(-n_fft // hop_length) * hop_length
    if span > n_fft:
        dft = np.pad(dft, ((0, 0), (0, span - n_fft)))
    mel_fb = mel_filter_bank(n_freqs, n_mels, sample_rate)
    dft.flags.writeable = False
    mel_fb.flags.writeable = False
    return dft, mel_fb


def log_mel_spectrogram(audio: torch.Tensor, cfg: WhisperConfig
                        ) -> torch.Tensor:
    """(B, n_samples) fp32 on any device -> (B, n_mels, n_frames) fp32 on
    that device. The caller pads or trims the audio to cfg.n_samples.

    Both matmuls run with TF32 off (`full_fp32`), in every compute dtype:
    the JAX frontend runs them at HIGHEST precision."""
    if audio.ndim == 1:
        audio = audio[None]
    dft_np, mel_np = _frontend_constants(cfg.n_fft, cfg.n_mels,
                                         cfg.sample_rate, cfg.hop_length)
    dev = audio.device
    dft = torch.tensor(dft_np, device=dev)                   # (2F, span)
    mel_fb = torch.tensor(mel_np, device=dev)                # (M, F)

    hop, pad = cfg.hop_length, cfg.n_fft // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad),
                                mode="reflect")[:, 0]
    B, T = x.shape
    n_frames = (T - cfg.n_fft) // hop + 1
    n_span = -(-cfg.n_fft // hop)
    n_chunks = n_frames + n_span - 1
    if n_chunks * hop > T:
        x = torch.nn.functional.pad(x, (0, n_chunks * hop - T))
    y = x[:, :n_chunks * hop].reshape(B, n_chunks, hop)
    frames = torch.cat([y[:, s:s + n_frames] for s in range(n_span)],
                       dim=-1)                               # (B, F, span)
    n_freqs = cfg.n_freqs
    with full_fp32():
        spec = torch.einsum("bts,fs->bft", frames, dft)      # (B, 2F, frames)
        power = spec[:, :n_freqs] ** 2 + spec[:, n_freqs:] ** 2
        mel = torch.einsum("mf,bft->bmt", mel_fb, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))[:, :, :-1]
    max_per = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, n_samples: int) -> np.ndarray:
    """Right-pad with zeros or truncate to one window."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    if audio.shape[0] >= n_samples:
        return audio[:n_samples]
    return np.pad(audio, (0, n_samples - audio.shape[0]))
