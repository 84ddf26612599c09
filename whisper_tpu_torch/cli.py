"""Command-line greedy transcription with the PyTorch/CUDA port
(whisper_tpu/cli.py:34, the flags of this slice only).

Usage:
    python -m whisper_tpu_torch.cli --random-weights --audio clip.wav
    python -m whisper_tpu_torch.cli --flat-bin whisper_tiny_weights.bin \
        --audio clip.wav --dtype bfloat16 --max-new 32
    python -m whisper_tpu_torch.cli --model large-v3-turbo --random-weights \
        --vocab vocab_v3.txt --audio clip.wav --dtype bfloat16

One <= 30 s window, greedy. The quant flags set the JAX CLI's int8
options one by one (--weight-quant and --self-kv-quant are bf16 serving
mode only; fp32 ignores --self-kv-quant and refuses --weight-quant);
the JAX serving policy is not applied (the port's quant default is off,
see pipeline.py). The device defaults to cuda and the command fails when
CUDA is absent; --device cpu runs the plain CPU versions of the kernels.
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
    p.add_argument("--vocab", help="vocab.txt path (default: bundled asset; "
                                   "large-v3 and turbo need their own)")
    p.add_argument("--audio", required=True, help="input WAV file (<= 30 s)")
    p.add_argument("--language", default="en")
    p.add_argument("--max-new", type=int, default=None,
                   help="cap on generated tokens (default 195)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="float32 = token-parity mode, bfloat16 = serving mode")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 self and cross caches (kv_cache_quant)")
    p.add_argument("--cross-kv-quant", action="store_true",
                   help="int8 cross cache (cross_kv_quant)")
    p.add_argument("--self-kv-quant", action="store_true",
                   help="int8 self cache, bf16 mode only (self_kv_quant)")
    p.add_argument("--weight-quant", action="store_true",
                   help="weight-only int8 decoder weights, bf16 mode only "
                        "(weight_quant)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.pipeline import (
        WhisperPipeline,
        load_wav,
        resolve_device,
    )

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    cfg = get_config(args.model).replace(
        kv_cache_quant=args.kv_quant, cross_kv_quant=args.cross_kv_quant,
        self_kv_quant=args.self_kv_quant, weight_quant=args.weight_quant)
    wav = load_wav(args.audio, cfg.sample_rate)
    if len(wav) > cfg.n_samples:
        p.error(f"--audio is {len(wav) / cfg.sample_rate:.1f} s; this port "
                f"transcribes one window of {cfg.chunk_length_s} s")
    if args.flat_bin:
        pipe = WhisperPipeline.from_flat_bin(args.flat_bin, cfg, args.dtype,
                                             args.device, args.vocab)
    else:
        pipe = WhisperPipeline.from_random(cfg, dtype=args.dtype,
                                           device=args.device,
                                           vocab_path=args.vocab)
    r = pipe.transcribe_window(wav, args.language, max_new=args.max_new)
    print(f"timings: {r.timings}")
    print("tokens:", r.tokens)
    print("text:", r.text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
