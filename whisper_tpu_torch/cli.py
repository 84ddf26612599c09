"""Command-line greedy transcription with the PyTorch/CUDA port
(whisper_tpu/cli.py:34, the flags of this slice only).

Usage:
    python -m whisper_tpu_torch.cli --random-weights --audio clip.wav
    python -m whisper_tpu_torch.cli --flat-bin whisper_tiny_weights.bin \
        --audio clip.wav --dtype bfloat16 --max-new 32

One <= 30 s window, greedy, unquantized. The device defaults to cuda and
the command fails when CUDA is absent; --device cpu runs the plain CPU
versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="tiny")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--flat-bin", help="reference-format flat fp32 weight blob")
    src.add_argument("--random-weights", action="store_true",
                     help="seeded random weights (no checkpoint needed)")
    p.add_argument("--audio", required=True, help="input WAV file (<= 30 s)")
    p.add_argument("--language", default="en")
    p.add_argument("--max-new", type=int, default=None,
                   help="cap on generated tokens (default 195)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="float32 = token-parity mode, bfloat16 = serving mode")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from whisper_tpu.config import get_config
    from whisper_tpu_torch.pipeline import (
        WhisperPipeline,
        load_wav,
        resolve_device,
    )

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    cfg = get_config(args.model)
    wav = load_wav(args.audio, cfg.sample_rate)
    if len(wav) > cfg.n_samples:
        p.error(f"--audio is {len(wav) / cfg.sample_rate:.1f} s; this port "
                f"transcribes one window of {cfg.chunk_length_s} s")
    if args.flat_bin:
        pipe = WhisperPipeline.from_flat_bin(args.flat_bin, cfg, args.dtype,
                                             args.device)
    else:
        pipe = WhisperPipeline.from_random(cfg, dtype=args.dtype,
                                           device=args.device)
    r = pipe.transcribe_window(wav, args.language, max_new=args.max_new)
    print(f"timings: {r.timings}")
    print("tokens:", r.tokens)
    print("text:", r.text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
