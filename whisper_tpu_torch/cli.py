"""Command-line transcription with the PyTorch/CUDA port
(whisper_tpu/cli.py:34, the flags of the ported slices).

Usage:
    python -m whisper_tpu_torch.cli --random-weights --audio clip.wav
    python -m whisper_tpu_torch.cli --weights w.npz --audio clip.wav \
        --beam 5 --timestamps --suppress-nonspeech
    python -m whisper_tpu_torch.cli --flat-bin whisper_tiny_weights.bin \
        --audio clip.wav --dtype bfloat16 --temperature 0.7 --seed 3
    python -m whisper_tpu_torch.cli --model large-v3-turbo --random-weights \
        --vocab vocab_v3.txt --audio clip.wav --dtype bfloat16

One <= 30 s window: greedy, beam search (--beam) or sampling
(--temperature, seeded by --seed), with the rule stack (--timestamps,
--suppress-nonspeech) and the silence gate (--no-speech-threshold). The
quant flags set the JAX CLI's int8 options one by one (--weight-quant and
--self-kv-quant are bf16 serving mode only; fp32 ignores --self-kv-quant
and refuses --weight-quant); as in the JAX CLI, the serving policy
(quant="auto", with the beam width as the effective decode rows) applies
unless --no-quant or an explicit quant flag is given. The device defaults
to cuda and the command fails when CUDA is absent; --device cpu runs the
plain CPU versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="tiny")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="npz checkpoint (named arrays)")
    src.add_argument("--flat-bin", help="reference-format flat fp32 weight blob")
    src.add_argument("--random-weights", action="store_true",
                     help="seeded random weights (no checkpoint needed)")
    p.add_argument("--vocab", help="vocab.txt path (default: bundled asset; "
                                   "large-v3 and turbo need their own)")
    p.add_argument("--audio", required=True, help="input WAV file (<= 30 s)")
    p.add_argument("--language", default="en",
                   help='language code, or "auto" to detect it')
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--max-new", type=int, default=None,
                   help="cap on generated tokens (default 195)")
    p.add_argument("--beam", type=int, default=1, help="beam size (1=greedy)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help=">0 enables sampling")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--timestamps", action="store_true",
                   help="decode with timestamp tokens + timestamp rules")
    p.add_argument("--suppress-nonspeech", action="store_true",
                   help="suppress the standard non-speech token set")
    p.add_argument("--no-speech-threshold", type=float, default=None,
                   metavar="P", help="drop the window's text when "
                        "P(<|nospeech|>) exceeds P and avg logprob is low "
                        "(openai semantics)")
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
    p.add_argument("--no-quant", action="store_true",
                   help="disable the bf16 serving policy (quant='auto'); "
                        "explicit --*-quant flags also suppress it")
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
    # one file at a time: the effective decode rows are the beam width
    load = dict(model=cfg, dtype=args.dtype, device=args.device,
                vocab_path=args.vocab,
                quant="off" if args.no_quant else "auto",
                batch_hint=max(1, args.beam))
    if args.flat_bin:
        pipe = WhisperPipeline.from_flat_bin(args.flat_bin, **load)
    elif args.weights:
        pipe = WhisperPipeline.from_npz(args.weights, **load)
    else:
        pipe = WhisperPipeline.from_random(**load)
    opts = None
    if args.beam > 1 or args.temperature > 0 or args.timestamps \
            or args.suppress_nonspeech:
        opts = pipe.make_options(
            timestamps=args.timestamps,
            suppress_nonspeech=args.suppress_nonspeech,
            temperature=args.temperature, beam_size=args.beam)
    r = pipe.transcribe_window(wav, args.language, args.task,
                               max_new=args.max_new, opts=opts,
                               seed=args.seed,
                               no_speech_threshold=args.no_speech_threshold)
    print(f"timings: {r.timings}")
    print("tokens:", r.tokens)
    print("text:", r.text)
    for seg in r.segments or ():
        end = "?" if seg["end"] is None else f"{seg['end']:.2f}"
        print(f"[{seg['start']:.2f} -> {end}] {seg['text']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
