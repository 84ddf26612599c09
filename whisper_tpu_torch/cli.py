"""Command-line transcription with the PyTorch/CUDA port
(whisper_tpu/cli.py, flag for flag, plus --device).

Usage:
    python -m whisper_tpu_torch.cli --random-weights --audio clip.wav
    python -m whisper_tpu_torch.cli --weights w.npz --audio clip.wav \
        --beam 5 --timestamps --suppress-nonspeech
    python -m whisper_tpu_torch.cli --weights w.npz --audio long.wav \
        --timestamps --condition-on-previous --word-timestamps \
        --vad-db -40 --output-format srt --output long.srt
    python -m whisper_tpu_torch.cli --model medium --weights medium.npz \
        --draft-model tiny --draft-weights tiny.npz --audio clip.wav
    python -m whisper_tpu_torch.cli --mel sample_input.bin \
        --flat-bin whisper_tiny_weights.bin --reference-detok
    python -m whisper_tpu_torch.cli --model large-v3-turbo --random-weights \
        --vocab vocab_v3.txt --audio clip.wav --dtype bfloat16

Audio of any length is read by native.load_audio (the C++ decoder and
resampler, or pipeline.load_wav without g++) and transcribed by
WhisperPipeline.transcribe: 30 s windows, seeking by the last closed
segment under --timestamps, conditioned on the previous window's text
with --condition-on-previous, silent windows skipped with --vad-db. The
strategies: greedy, beam search (--beam) or sampling (--temperature,
seeded by --seed), with the rule stack (--timestamps,
--suppress-nonspeech) and the silence gate (--no-speech-threshold).
--mel decodes a precomputed mel (n_mels x n_frames fp32) in one call.
--draft-model decodes one <= 30 s window speculatively: the tokens are the
target's greedy tokens. --output-format renders the transcript as text,
SRT, VTT, TSV or JSON (segments from the timestamp tokens, else from the
word timings, else one segment for the whole file).

The quant flags set the JAX CLI's int8 options one by one
(--weight-quant and --self-kv-quant are bf16 serving mode only; fp32
ignores --self-kv-quant and refuses --weight-quant); as in the JAX CLI,
the serving policy (quant="auto", with the beam width as the effective
decode rows) applies unless --no-quant or an explicit quant flag is
given. The device defaults to cuda and the command fails when CUDA is
absent; --device cpu runs the plain CPU versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="tiny")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="npz checkpoint (named arrays)")
    src.add_argument("--flat-bin", help="reference-format flat fp32 weight blob")
    src.add_argument("--random-weights", action="store_true",
                     help="seeded random weights (no checkpoint needed)")
    p.add_argument("--audio", help="input WAV file")
    p.add_argument("--mel", help="precomputed mel .bin (n_mels x n_frames "
                                 "fp32, the reference's sample_input.bin)")
    p.add_argument("--vocab", help="vocab.txt path (default: bundled asset; "
                                   "large-v3 and turbo need their own)")
    p.add_argument("--language", default="en",
                   help='language code, or "auto" to detect it')
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--reference-detok", action="store_true",
                   help="with --mel: the reference's lossy Ġ/\\n "
                        "detokenizer")
    p.add_argument("--max-new", type=int, default=None,
                   help="cap on generated tokens a window (default 195)")
    p.add_argument("--beam", type=int, default=1, help="beam size (1=greedy)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help=">0 enables sampling")
    p.add_argument("--timestamps", action="store_true",
                   help="decode with timestamp tokens + timestamp rules")
    p.add_argument("--suppress-nonspeech", action="store_true",
                   help="suppress the standard non-speech token set")
    p.add_argument("--condition-on-previous", action="store_true",
                   help="long-form: condition each window on previous text")
    p.add_argument("--word-timestamps", action="store_true",
                   help="emit per-word timings (cross-attention DTW)")
    p.add_argument("--output-format", choices=["text", "srt", "vtt", "tsv",
                                               "json"], default="text")
    p.add_argument("--output", help="write the formatted transcript here "
                                    "(default: stdout)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="float32 = token-parity mode, bfloat16 = serving mode")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 self and cross caches (kv_cache_quant)")
    p.add_argument("--self-kv-quant", action="store_true",
                   help="int8 self cache, bf16 mode only (self_kv_quant)")
    p.add_argument("--cross-kv-quant", action="store_true",
                   help="int8 cross cache (cross_kv_quant)")
    p.add_argument("--no-quant", action="store_true",
                   help="disable the bf16 serving policy (quant='auto'); "
                        "explicit --*-quant flags also suppress it")
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding with this family member as "
                        "the draft (same vocab required, e.g. tiny drafts "
                        "medium, turbo drafts large-v3); the tokens are the "
                        "target's greedy tokens")
    p.add_argument("--draft-weights", default=None,
                   help="npz checkpoint for the draft model")
    p.add_argument("--draft-flat-bin", default=None,
                   help="flat-bin weights for the draft model")
    p.add_argument("--draft-k", type=int, default=4,
                   help="draft tokens proposed per verify round")
    p.add_argument("--weight-quant", action="store_true",
                   help="weight-only int8 decoder weights, bf16 mode only "
                        "(weight_quant)")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--vad-db", type=float, default=None, metavar="DB",
                   help="energy VAD gate: skip 30 s windows whose frames "
                        "never exceed this dBFS (e.g. -40)")
    p.add_argument("--no-speech-threshold", type=float, default=None,
                   metavar="P", help="drop a window's text when "
                        "P(<|nospeech|>) exceeds P and avg logprob is low "
                        "(openai semantics)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline, resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    if not (args.audio or args.mel):
        p.error("need --audio or --mel")
    cfg = get_config(args.model).replace(
        kv_cache_quant=args.kv_quant, cross_kv_quant=args.cross_kv_quant,
        self_kv_quant=args.self_kv_quant, weight_quant=args.weight_quant)
    quant = "off" if args.no_quant else "auto"
    # one file at a time: the effective decode rows are the beam width
    load = dict(dtype=args.dtype, device=args.device, vocab_path=args.vocab,
                quant=quant)
    rows = max(1, args.beam)
    if args.flat_bin:
        pipe = WhisperPipeline.from_flat_bin(args.flat_bin, cfg, **load,
                                             batch_hint=rows)
    elif args.weights:
        pipe = WhisperPipeline.from_npz(args.weights, cfg, **load,
                                        batch_hint=rows)
    else:
        pipe = WhisperPipeline.from_random(cfg, **load, batch_hint=rows)
    cfg = pipe.cfg                  # the serving policy may have set flags
    opts = None
    if args.beam > 1 or args.temperature > 0 or args.timestamps \
            or args.suppress_nonspeech:
        opts = pipe.make_options(
            timestamps=args.timestamps,
            suppress_nonspeech=args.suppress_nonspeech,
            temperature=args.temperature, beam_size=args.beam)

    if args.mel:
        return _mel(args, pipe, opts)

    from whisper_tpu_torch.native import load_audio
    wav = load_audio(args.audio, cfg.sample_rate)

    if args.draft_model:
        if args.beam > 1 or args.temperature > 0 or opts is not None:
            p.error("--draft-model supports plain greedy only "
                    "(no beam/temperature/timestamps rules)")
        if cfg.self_kv_quant:
            print("warning: --draft-model runs with self_kv_quant "
                  "disabled (speculative verify requires the bf16 self "
                  "cache); tokens match sq-OFF greedy", file=sys.stderr)
        if len(wav) > cfg.n_samples:
            p.error("--draft-model currently transcribes one <=30 s window")
        d_cfg = get_config(args.draft_model)
        if args.draft_flat_bin:
            draft = WhisperPipeline.from_flat_bin(args.draft_flat_bin, d_cfg,
                                                  **load)
        elif args.draft_weights:
            draft = WhisperPipeline.from_npz(args.draft_weights, d_cfg,
                                             **load)
        elif args.random_weights:
            draft = WhisperPipeline.from_random(d_cfg, seed=3, **load)
        else:
            p.error("--draft-model needs --draft-weights / --draft-flat-bin "
                    "(or --random-weights)")
        from whisper_tpu_torch.speculative import spec_transcribe_window
        r = spec_transcribe_window(pipe, draft, wav, args.language,
                                   args.task, max_new=args.max_new,
                                   k=args.draft_k)
        print(f"timings: {r.timings}")
        print("tokens:", r.tokens)
        print("text:", r.text)
        return 0

    r = pipe.transcribe(wav, args.language, args.task, max_new=args.max_new,
                        opts=opts,
                        condition_on_previous=args.condition_on_previous,
                        word_timestamps=args.word_timestamps,
                        no_speech_threshold=args.no_speech_threshold,
                        vad_threshold_db=args.vad_db, seed=args.seed)
    print(f"timings: {r.timings}")
    print("tokens:", r.tokens)
    print("text:", r.text)
    for seg in r.segments or ():
        end = "?" if seg["end"] is None else f"{seg['end']:.2f}"
        print(f"[{seg['start']:.2f} -> {end}] {seg['text']}")
    if r.words:
        print("words:", " ".join(
            f"{w.word.strip()}[{w.start:.2f}-{w.end:.2f}]" for w in r.words))

    if args.output_format != "text" or args.output:
        from whisper_tpu_torch import formats
        segs = r.segments or (formats.words_to_segments(r.words)
                              if r.words else
                              [{"start": 0.0, "end": len(wav) / cfg.sample_rate,
                                "text": r.text}])
        rendered = {
            "text": r.text,
            "srt": formats.to_srt(segs),
            "vtt": formats.to_vtt(segs),
            "tsv": formats.to_tsv(segs),
            "json": formats.to_json(r.text, r.segments, r.words,
                                    language=args.language),
        }[args.output_format]
        if args.output:
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(rendered + "\n")
        else:
            print(rendered)
    return 0


def _mel(args, pipe, opts) -> int:
    """--mel: one decode of a precomputed (n_mels, n_frames) fp32 mel."""
    import numpy as np
    import torch

    from whisper_tpu_torch.decode import transcribe_tokens

    cfg = pipe.cfg
    mel = np.fromfile(args.mel, dtype="<f4").reshape(cfg.n_mels, cfg.n_frames)
    prompt = pipe.prompt(1, args.language, args.task,
                         timestamps=args.timestamps)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=pipe.device)
        generator.manual_seed(args.seed)
    t0 = time.perf_counter()
    res = transcribe_tokens(pipe.params, cfg,
                            torch.from_numpy(mel)[None].to(pipe.device),
                            prompt, max_new=args.max_new, opts=opts,
                            beam_size=args.beam, generator=generator)
    ids = res.tokens[0, :int(res.lengths[0])].tolist()
    dt = time.perf_counter() - t0
    text = (pipe.tokenizer.decode_reference(ids) if args.reference_detok
            else pipe.tokenizer.decode(ids))
    print(f"transcribe: {dt:.3f}s")
    print("tokens:", ids)
    print("text:", text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
