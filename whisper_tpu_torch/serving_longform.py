"""Concurrent long-form transcription over the continuous engine
(whisper_tpu/serving_longform.py).

`pipeline.WhisperPipeline.transcribe` drives the 30 s windows of ONE file
back to back: between a file's windows the device sees batch-1 work. This
driver runs MANY long files at once by chaining each file's windows
through `ContinuousBatcher`: window k+1 of a file is submitted the moment
window k is harvested, carrying the previous window's text as
`<|startofprev|>` conditioning, while windows of other files keep the
slot batch full.

Window semantics mirror pipeline.transcribe: a fixed 30 s advance, or
seek by the last closed segment when the engine decodes timestamps; the
optional energy-VAD window skip; optional cross-window conditioning. The
driver runs on the engine's thread (its callbacks fire inside the
engine's harvest) and launches nothing itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from whisper_tpu_torch.audio import energy_vad
from whisper_tpu_torch.serving_continuous import ContinuousBatcher
from whisper_tpu_torch.tokenizer import split_segments


@dataclasses.dataclass
class LongFormResult:
    text: str
    tokens: list
    segments: Optional[list]
    windows: int


@dataclasses.dataclass
class _FileState:
    audio: np.ndarray
    language: str
    task: str
    seek: int = 0
    windows: int = 0
    prev: tuple = ()
    texts: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    segments: list = dataclasses.field(default_factory=list)
    done: bool = False
    callback: Optional[object] = None    # callback(fid, LongFormResult)
    on_token: Optional[object] = None    # on_token(fid, token_id)


class LongFormDriver:
    """Chains per-file windows through a shared ContinuousBatcher.

    Usage:
        eng = ContinuousBatcher(params, cfg, max_slots=8, opts=...)
        drv = LongFormDriver(eng, condition_on_previous=True)
        fids = [drv.submit(audio) for audio in files]
        results = drv.run()          # {fid: LongFormResult}
    """

    def __init__(self, batcher: ContinuousBatcher,
                 condition_on_previous: bool = True,
                 vad_threshold_db: Optional[float] = None,
                 retain_results: bool = True):
        self.b = batcher
        self.cfg = batcher.cfg
        self.condition = condition_on_previous
        self.vad_db = vad_threshold_db
        # retain_results=False prunes each _FileState at completion (the
        # long-lived server mode: results are delivered via callback; an
        # immortal driver must not retain every request's audio/tokens)
        self.retain = retain_results
        self._use_seek = bool(batcher.opts and batcher.opts.timestamps)
        self._files: dict[int, _FileState] = {}
        self._next_fid = 0
        self._rid_to_fid: dict[int, int] = {}

    # ---- client API ----
    def submit(self, audio: np.ndarray, language: str = "en",
               task: str = "transcribe", callback=None,
               on_token=None) -> int:
        """Queue a long file. `callback(fid, LongFormResult)` fires when
        the final window is harvested (for server-style drivers that pump
        the engine themselves instead of calling run()); `on_token(fid,
        token_id)` streams each window's generated tokens as committed."""
        fid = self._next_fid
        self._next_fid += 1
        st = _FileState(np.asarray(audio, np.float32).reshape(-1),
                        language, task, callback=callback,
                        on_token=on_token)
        self._files[fid] = st
        self._advance(fid)               # submit the first window
        return fid

    def run(self, max_steps: int = 1_000_000) -> dict[int, LongFormResult]:
        """Drive the engine until every submitted file is complete."""
        self.b.run_until_idle(max_steps=max_steps)
        return {fid: self._result(st) for fid, st in self._files.items()}

    def cancel(self, fid: int) -> None:
        """Stop chaining further windows of file fid (e.g. the client
        timed out). The window currently decoding finishes normally —
        slots cannot be aborted mid-decode — then the chain ends and the
        file's state is dropped."""
        st = self._files.get(fid)
        if st is not None and not st.done:
            st.done = True               # _on_window sees done: no chain
            st.callback = None
            st.on_token = None
            if fid in self._files and not self.retain:
                in_flight = fid in self._rid_to_fid.values()
                if not in_flight:
                    del self._files[fid]

    # ---- window chaining ----
    def _advance(self, fid: int) -> None:
        """Submit the next non-silent window of file fid, or mark done."""
        cfg = self.cfg
        st = self._files[fid]
        n = cfg.n_samples
        while st.seek < max(len(st.audio), 1):
            chunk = st.audio[st.seek:st.seek + n]
            if (self.vad_db is not None
                    and not energy_vad(chunk, cfg.sample_rate,
                                       threshold_db=self.vad_db)):
                st.seek += n             # silent window: skip entirely
                if len(chunk) < n:
                    break
                continue
            on_tok = None
            if st.on_token is not None:
                on_tok = (lambda _rid, tid, f=fid, cb=st.on_token:
                          cb(f, tid))
            # windows after the first bypass the admission bound (the
            # file is already receiving service; see submit(admitted=))
            rid = self.b.submit(chunk, st.language, st.task,
                                callback=self._on_window,
                                on_token=on_tok,
                                prev_tokens=list(st.prev),
                                admitted=st.windows > 0)
            self._rid_to_fid[rid] = fid
            return
        self._finish(fid)

    def _on_window(self, rid: int, ids: list) -> None:
        """Harvest one window: accumulate, compute seek/conditioning,
        chain the next window. Runs inside the engine's harvest, so the
        next submit lands in this very drive loop."""
        cfg = self.cfg
        fid = self._rid_to_fid.pop(rid)
        st = self._files.get(fid)
        if st is None or st.done:        # cancelled mid-flight: end chain
            if st is not None and not self.retain:
                self._files.pop(fid, None)
            return
        offset_s = st.seek / cfg.sample_rate
        chunk_len = min(len(st.audio) - st.seek, cfg.n_samples)
        st.windows += 1

        # strip the forced prompt (sot..task..) — keep generated ids only
        # (prompt length varies with prev conditioning; generated region
        # starts after the forced tokens, which the engine kept in ids)
        sot = ids.index(cfg.sot_token) if cfg.sot_token in ids else 0
        gen_start = len(ids)             # all-specials window -> empty gen
        for i in range(sot, len(ids)):
            if ids[i] < cfg.eot_token or ids[i] >= cfg.timestamp_begin:
                gen_start = i
                break
        gen = [t for t in ids[gen_start:] if t != cfg.eot_token]
        # result tokens keep each window's SOT-onward region (prompt
        # specials + generated), matching pipeline.transcribe and the
        # short-request server contract: tokens[0] == SOT either way
        st.tokens.extend(ids[sot:])
        text_ids = [t for t in gen if t < cfg.eot_token]
        st.texts.append(self.b.tokenizer.decode(text_ids))

        advance_s = float(cfg.chunk_length_s)
        if self._use_seek:
            segs = split_segments(cfg, gen, self.b.tokenizer,
                                  window_offset_s=offset_s)
            if segs:
                st.segments.extend(segs)
                last_end = segs[-1].get("end")
                if last_end is not None:
                    advance_s = max(last_end - offset_s, 1.0)
        if self.condition:
            st.prev = tuple(text_ids[-(cfg.n_text_ctx // 2 - 8):])

        st.seek += int(round(advance_s * cfg.sample_rate))
        if chunk_len < cfg.n_samples:
            self._finish(fid)            # that was the final window
            return
        self._advance(fid)

    def _finish(self, fid: int) -> None:
        st = self._files[fid]
        st.done = True
        st.audio = np.empty(0, np.float32)   # release the largest buffer
        if st.callback is not None:
            st.callback(fid, self._result(st))
        if not self.retain:
            del self._files[fid]

    def _result(self, st: _FileState) -> LongFormResult:
        return LongFormResult(text="".join(st.texts),
                              tokens=list(st.tokens),
                              segments=st.segments or None,
                              windows=st.windows)
