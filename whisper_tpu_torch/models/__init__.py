"""Whisper encoder/decoder in PyTorch (whisper_tpu/models)."""
