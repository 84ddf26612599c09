"""A plain Whisper in fp32 PyTorch: log-mel, encoder, decoder with cross
attention, and logits, written from the published model (openai/whisper
`model.py`, `audio.py`) and independent of the code under test.

It imports nothing of `whisper_tpu`, `whisper_tpu_torch` or JAX, and
takes from the benchmark only the configuration, the weights tree that
`portbench.weights.make` draws from the seed, and the raw audio.

`policy` says where the served model rounds to integers, so that the
reference can work out again what a quantized program derives from the
same weights (each in fp32: values quantized, then multiplied back):

  * "enc_bits": the encoder's QKV, O, FC1 and FC2 with the weight
    quantized per output column and the activations per row;
  * "dec_bits": the decoder's self QKV and O, cross Q and O, FC1, FC2
    quantized per output column, the token table per row (the tied
    logits' output axis); cross K/V weights stay as they are;
  * "cross_bits": the cross K/V cache per vector of a head's width;
  * "self_bits": the self K/V cache per vector.

Each is the symmetric form: scale = max|x| / (2^(bits-1) - 1), at least
1e-10; values rounded half to even and clipped. None leaves a place
unquantized. The benchmark's control is this model with 4 where the
configuration states 8.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

MEL_CACHE: dict = {}


def fake_quant(x: torch.Tensor, dim: int, bits: Optional[int]
               ) -> torch.Tensor:
    """x rounded to `bits`-bit symmetric integers along `dim` and scaled
    back, in fp32; x itself when bits is None."""
    if bits is None:
        return x
    qmax = 2 ** (bits - 1) - 1
    s = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True) / qmax, 1e-10)
    return (x / s).round().clamp(-qmax, qmax) * s


# ---------------------------------------------------------------------------
# log-mel (openai/whisper audio.py: 400-point periodic Hann STFT, hop 160,
# |X|^2, Slaney mel filters, log10 clamped at 1e-10, max - 8, (x + 4) / 4)
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                               * (m - 15.0)), lin)


def mel_filters(n_mels: int, n_fft: int = 400, sr: int = 16_000
                ) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) with its defaults (Slaney
    scale, Slaney area normalisation, 0 to sr / 2): (n_mels, n_fft/2+1)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                 n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, samples) fp32 -> (B, n_mels, samples // 160) fp32."""
    dev = audio.device
    key = (n_mels, str(dev))
    if key not in MEL_CACHE:
        MEL_CACHE[key] = torch.from_numpy(mel_filters(n_mels)).to(dev)
    window = torch.hann_window(400, periodic=True, device=dev)
    stft = torch.stft(audio.float(), 400, 160, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    spec = torch.log10(torch.clamp(MEL_CACHE[key] @ power, min=1e-10))
    spec = torch.maximum(spec, spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree, in fp32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["g"].float(), p["b"].float(),
                        1e-5)


def linear(x: torch.Tensor, p: dict, w_bits=None, x_bits=None
           ) -> torch.Tensor:
    """x @ w + b, w (in, out): w quantized per output column (over its in
    axis), x per row, when given bits."""
    w = fake_quant(p["w"].float(), -2, w_bits)
    return fake_quant(x, -1, x_bits) @ w + p["b"].float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, causal: bool = False) -> torch.Tensor:
    """(B, T, d) x (B, S, d) -> (B, T, d): softmax(q k^T / sqrt(D)) v per
    head; causal masks key j > query i (queries and keys start at 0)."""
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // heads
    qh = q.view(b, t, heads, dh).transpose(1, 2)
    kh = k.view(b, s, heads, dh).transpose(1, 2)
    vh = v.view(b, s, heads, dh).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, t, d)


def encoder(w: dict, cfg: dict, mel: torch.Tensor, policy: dict
            ) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, 1500, d)."""
    enc = w["encoder"]
    heads = cfg["encoder_attention_heads"]
    bits = policy.get("enc_bits")
    x = F.gelu(F.conv1d(mel, enc["conv1"]["w"].float(),
                        enc["conv1"]["b"].float(), padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2"]["w"].float(),
                        enc["conv2"]["b"].float(), stride=2, padding=1))
    x = x.transpose(1, 2) + enc["pos_emb"].float()
    for i in range(cfg["encoder_layers"]):
        p = layer(enc["layers"], i)
        y = ln(x, p["attn_ln"])
        q, k, v = (linear(y, p["attn"][n], bits, bits) for n in "qkv")
        x = x + linear(attention(q, k, v, heads), p["attn"]["o"], bits, bits)
        y = ln(x, p["mlp_ln"])
        x = x + linear(F.gelu(linear(y, p["fc1"], bits, bits)), p["fc2"],
                       bits, bits)
    return ln(x, enc["ln_post"])


def decoder_logits(w: dict, cfg: dict, enc_out: torch.Tensor,
                   tokens: torch.Tensor, policy: dict) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab) fp32 of `tokens` (B, T) at
    positions [0, T) over the encoder output (B, 1500, d)."""
    dec = w["decoder"]
    heads = cfg["decoder_attention_heads"]
    wb, cb, sb = policy.get("dec_bits"), policy.get("cross_bits"), \
        policy.get("self_bits")
    d = cfg["d_model"]
    dh = d // heads
    emb = fake_quant(dec["tok_emb"].float(), -1, wb)
    t = tokens.shape[1]
    h = emb[tokens] + dec["pos_emb"][:t].float()

    def per_vector(x, bits):
        b, s, _ = x.shape
        return fake_quant(x.view(b, s, heads, dh), -1, bits).view(b, s, d)

    for i in range(cfg["decoder_layers"]):
        p = layer(dec["layers"], i)
        y = ln(h, p["attn_ln"])
        q, k, v = (linear(y, p["attn"][n], wb) for n in "qkv")
        k, v = per_vector(k, sb), per_vector(v, sb)
        h = h + linear(attention(q, k, v, heads, causal=True),
                       p["attn"]["o"], wb)
        y = ln(h, p["cross_ln"])
        q = linear(y, p["cross_attn"]["q"], wb)
        k = per_vector(linear(enc_out, p["cross_attn"]["k"]), cb)
        v = per_vector(linear(enc_out, p["cross_attn"]["v"]), cb)
        h = h + linear(attention(q, k, v, heads), p["cross_attn"]["o"], wb)
        y = ln(h, p["mlp_ln"])
        h = h + linear(F.gelu(linear(y, p["fc1"], wb)), p["fc2"], wb)
    return ln(h, dec["ln"]) @ emb.t()


def fp32_exact():
    """A context with TF32 off for matmuls and convolutions, restored on
    exit: on the H100 an fp32 product may otherwise run in TF32."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
    return _Ctx()


@torch.inference_mode()
def served_logits(w: dict, cfg: dict, audio: np.ndarray, prompts: list,
                  served: list, policy: dict, device, block: int = 2
                  ) -> list:
    """For each request i (audio row i, prompt ids, served ids), the
    logits (len(served), vocab) fp32 at the positions that chose each
    served token: the reference run once over prompt + served. Rows go
    `block` at a time, so the encoder's scores fit."""
    out = []
    with fp32_exact():
        for at in range(0, len(prompts), block):
            rows = range(at, min(at + block, len(prompts)))
            wav = torch.from_numpy(np.ascontiguousarray(audio[at:rows[-1] + 1])
                                   ).to(device)
            enc = encoder(w, cfg, log_mel(wav, cfg["num_mel_bins"]), policy)
            for j, i in enumerate(rows):
                seq = list(prompts[i]) + list(served[i][:-1])
                tok = torch.tensor([seq], dtype=torch.long, device=device)
                lg = decoder_logits(w, cfg, enc[j:j + 1], tok, policy)[0]
                p = len(prompts[i])
                out.append(lg[p - 1:p - 1 + len(served[i])])
    return out
