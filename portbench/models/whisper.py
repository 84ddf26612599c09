"""Whisper's model type: the encoder-decoder of openai/whisper, whose
weights `portbench.weights.make` draws in the port's layout and whose
plain reference is `portbench.reference.model`."""

from __future__ import annotations

from portbench import weights
from portbench.reference import model

make = weights.make
served_logits = model.served_logits


def preset_pairs(ctx) -> list:
    """(key, configuration file's value, the port's preset's value) for
    each published size that the cell's `model` preset must share with
    the configuration file."""
    from whisper_tpu_torch.config import get_config
    p = get_config(ctx.cell["model"])
    c = ctx.config
    return [(k, c[k], v) for k, v in (
        ("d_model", p.d_model), ("encoder_attention_heads", p.n_heads),
        ("encoder_layers", p.n_audio_layers),
        ("decoder_layers", p.n_text_layers), ("num_mel_bins", p.n_mels),
        ("vocab_size", p.vocab_size), ("encoder_ffn_dim", p.d_ff),
        ("eos_token_id", p.eot_token),
        ("decoder_start_token_id", p.sot_token),
        ("transcribe_token_id", p.transcribe_token),
        ("prev_sot_token_id", p.sot_prev_token),
        ("no_timestamps_token_id", p.no_timestamps_token))]
