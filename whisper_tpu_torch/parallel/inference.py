"""Multi-process inference: dp x sp x tp sharded transcription
(whisper_tpu/parallel/inference.py).

Every rank of the world constructs the same ShardedPipeline and calls
transcribe_batch with the same global batch, as every host of a JAX
program does:
  * dp: each rank takes its rows of the batch (audio, mel, prompt and
    caches), and the tokens are gathered over dp at the end, so every rank
    returns the whole batch;
  * tp: the rank's heads and vocab rows (mesh.shard_params), with the
    row-parallel sums and the logits' gather written out
    (models.whisper.sharded);
  * sp: the encoder's frames split over sp, its keys and values gathered
    for attention, its output gathered before the decoder.

Usage, in each of dp * sp * tp processes (parallel.launch.run, or torchrun
with multihost.initialize; one process needs neither):
    pipe = ShardedPipeline(params, "large-v3", dp=2, tp=4)
    result = pipe.transcribe_batch(audio_batch)      # (B,) texts

Differences from the JAX module, decided: under tp > 1 the encoder runs
its tail-off branch (the flash kernel on the rank's heads), since the
fused tail kernel would need the o-projection's sum inside its launch; at
tp = 1 each rank runs the one-card encoder, tail kernel included. The
fused decoder step refuses tp > 1 for the same reason.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
from whisper_tpu_torch.config import WhisperConfig, get_config
from whisper_tpu_torch.decode import _fused_step_enabled, encode, greedy_decode
from whisper_tpu_torch.decode_rules import DecodeOptions
from whisper_tpu_torch.models.whisper import compute_dtype, sharded
from whisper_tpu_torch.ops import collectives
from whisper_tpu_torch.parallel.mesh import (
    axis_group,
    make_mesh,
    shard_params,
    shard_tensor,
)
from whisper_tpu_torch.pipeline import resolve_device
from whisper_tpu_torch.tokenizer import Tokenizer, build_prompt
from whisper_tpu_torch.weights import to_device


class ShardedPipeline:
    """Transcription over a (dp, sp, tp) mesh of processes. The batch must
    be a multiple of dp; n_heads must divide by tp (every family member
    with tp in {1, 2, 4}, and most with 8)."""

    def __init__(self, params, cfg: WhisperConfig | str, dp: int = 1,
                 tp: int = 1, sp: int = 1, device="cuda",
                 tokenizer: Optional[Tokenizer] = None):
        """params: the whole params tree with q, k and v apart (init_params,
        a loader, or weights.from_jax_params), the same on every rank; each
        rank keeps its shard, cast by the to_device rule and placed on
        `device` ("cuda" unless the caller asks for the CPU)."""
        self.cfg = get_config(cfg) if isinstance(cfg, str) else cfg
        if self.cfg.n_heads % tp:
            raise ValueError(f"tp={tp} must divide n_heads={self.cfg.n_heads}")
        if tp > 1 and _fused_step_enabled(self.cfg):
            raise ValueError("the fused decoder step does not run under "
                             "tp > 1: turn cfg.fused_step and "
                             "WHISPER_TPU_FUSED off")
        self.device = resolve_device(device)
        self.mesh = make_mesh(dp=dp, tp=tp, sp=sp,
                              device_type=self.device.type)
        self.dp, self.tp, self.sp = dp, tp, sp
        dtype = compute_dtype(self.cfg)
        self.params = to_device(shard_params(params, self.mesh), self.device,
                                None if dtype == torch.float32 else dtype)
        self.tokenizer = tokenizer or Tokenizer(config=self.cfg)

    def sharding(self):
        """The block the model's functions run in on this rank's shard
        (models.whisper.sharded with the mesh's tp and sp groups)."""
        return sharded(tp=axis_group(self.mesh, "tp"),
                       sp=axis_group(self.mesh, "sp"))

    def rows(self, x) -> torch.Tensor:
        """This rank's dp rows of a global batch, on the pipeline's
        device."""
        return shard_tensor(torch.as_tensor(x), ("dp",),
                            self.mesh).to(self.device)

    def transcribe_batch(self, audio: np.ndarray,
                         language: str = "en", task: str = "transcribe",
                         max_new: Optional[int] = None,
                         opts: Optional[DecodeOptions] = None) -> list[dict]:
        """audio: (B, <=n_samples) float32, B % dp == 0, the same on every
        rank. Greedy decoding (with opts' rules). Returns per-row {"text",
        "tokens"} for the whole batch on every rank."""
        cfg = self.cfg
        audio = np.asarray(audio, np.float32)
        B = audio.shape[0]
        if B % self.dp:
            raise ValueError(f"batch {B} not divisible by dp={self.dp}")
        padded = np.stack([pad_or_trim(a, cfg.n_samples) for a in audio])
        prompt = np.tile(
            np.asarray(build_prompt(cfg, language, task,
                                    timestamps=bool(opts and opts.timestamps)),
                       np.int64), (B, 1))
        with torch.inference_mode(), self.sharding():
            mel = log_mel_spectrogram(self.rows(padded), cfg)
            enc = encode(self.params, cfg, mel)
            res = greedy_decode(self.params, cfg, enc, self.rows(prompt),
                                max_new=max_new, opts=opts)
            dp_group = axis_group(self.mesh, "dp")
            tokens = collectives.all_gather(res.tokens, dp_group, 0).cpu()
            lengths = collectives.all_gather(res.lengths, dp_group, 0).cpu()
        rows = [tokens[b, :lengths[b]].tolist() for b in range(B)]
        return [{"text": self.tokenizer.decode(ids), "tokens": ids}
                for ids in rows]
