"""Wall time of the port's unsharded greedy decode on the card: the bench
workload (B=32 synthetic 30 s clips, 89 tokens a row with EOT banned, so
every run does the same work) through WhisperPipeline.transcribe_batch,
bf16, with weights drawn on the card from seed 0.

    python3 tools/decode_wall.py [--tree DIR] [--models tiny,large-v3-turbo]
                                 [--runs 5]

--tree: the checkout whose whisper_tpu_torch is imported (default: this
one), so that two trees can be timed in one call on one card, e.g.
parent, change, change, parent. The helpers (card weights, clips, the v3
vocab) come from this checkout's chip_smoke.py. Prints one JSON line per
model: the wall of each of `--runs` runs after a warm-up, their median,
the package's path and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE)
    ap.add_argument("--models", default="tiny,large-v3-turbo")
    ap.add_argument("--runs", type=int, default=5)
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.tree))
    import torch
    if not torch.cuda.is_available():
        print("decode_wall: no CUDA device", file=sys.stderr)
        return 1
    import whisper_tpu_torch
    from whisper_tpu_torch import get_config
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.tokenizer import Tokenizer
    cs = _chip_smoke()
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        vocab = cs.write_v3_vocab(
            Tokenizer(config=get_config("tiny")).tokens, tmp)
        for model in opts.models.split(","):
            cfg = get_config(model).replace(compute_dtype="bfloat16")
            pipe = WhisperPipeline.from_params(
                cs.card_init_params(cfg, 0), cfg, dtype="bfloat16",
                device="cuda", vocab_path=vocab, quant="off")
            audio = cs.bench_audio(cfg, cs.BATCH)
            bias = torch.zeros(cfg.vocab_size, device="cuda")
            bias[cfg.eot_token] = -1e9
            walls = []
            for i in range(opts.runs + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = pipe.transcribe_batch(audio, max_new=cs.GEN_TOKENS - 1,
                                            logit_bias=bias)
                torch.cuda.synchronize()
                if i:                               # run 0 is the warm-up
                    walls.append(time.perf_counter() - t0)
            assert tuple(res.tokens.shape) == (cs.BATCH, 4 + cs.GEN_TOKENS)
            print(json.dumps({
                "phase": "decode_wall_unsharded", "model": model,
                "dtype": "bfloat16", "batch": cs.BATCH,
                "gen_tokens": cs.GEN_TOKENS, "walls_s": walls,
                "median_s": statistics.median(walls),
                "package": os.path.dirname(whisper_tpu_torch.__file__),
                "card": card}), flush=True)
            del pipe, res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
