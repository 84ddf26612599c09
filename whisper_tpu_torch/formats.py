"""Subtitle and transcript output formats: SRT, VTT, TSV and JSON, and
word timings grouped into display segments (whisper_tpu/formats.py, a
copy: the JAX module is pure Python, but the port imports nothing of the
JAX package).

Sources: segment timestamps (the timestamp-token grammar,
tokenizer.split_segments) or word timings (alignment.WordTiming); the
pipeline attaches both to its Transcription.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional


def _fmt_ts(seconds: float, sep: str = ",") -> str:
    ms = int(round(max(seconds, 0.0) * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def _end(seg: dict, fallback_pad: float = 2.0) -> float:
    e = seg.get("end")
    return float(e) if e is not None else float(seg["start"]) + fallback_pad


def to_srt(segments: Iterable[dict]) -> str:
    """SubRip: 1-indexed blocks, HH:MM:SS,mmm --> HH:MM:SS,mmm."""
    lines = []
    for i, seg in enumerate(segments, start=1):
        lines.append(str(i))
        lines.append(f"{_fmt_ts(seg['start'])} --> {_fmt_ts(_end(seg))}")
        lines.append(seg["text"].strip())
        lines.append("")
    return "\n".join(lines)


def to_vtt(segments: Iterable[dict]) -> str:
    """WebVTT: header + HH:MM:SS.mmm --> HH:MM:SS.mmm cues."""
    lines = ["WEBVTT", ""]
    for seg in segments:
        lines.append(f"{_fmt_ts(seg['start'], '.')} --> {_fmt_ts(_end(seg), '.')}")
        lines.append(seg["text"].strip())
        lines.append("")
    return "\n".join(lines)


def to_tsv(segments: Iterable[dict]) -> str:
    """start\tend\ttext with integer milliseconds (openai CLI layout)."""
    lines = ["start\tend\ttext"]
    for seg in segments:
        lines.append(f"{int(round(seg['start'] * 1000))}\t"
                     f"{int(round(_end(seg) * 1000))}\t"
                     f"{seg['text'].strip()}")
    return "\n".join(lines)


def to_json(text: str, segments: Optional[list] = None,
            words: Optional[list] = None, language: Optional[str] = None) -> str:
    doc: dict = {"text": text}
    if language:
        doc["language"] = language
    if segments:
        doc["segments"] = [
            {"start": s["start"], "end": s.get("end"), "text": s["text"]}
            for s in segments]
    if words:
        doc["words"] = [
            {"word": w.word, "start": w.start, "end": w.end} for w in words]
    return json.dumps(doc, ensure_ascii=False, indent=2)


def words_to_segments(words: list, max_gap_s: float = 0.8,
                      max_len_chars: int = 80) -> list[dict]:
    """Group word timings into display segments (split at pauses or when a
    line grows too long) — lets --word-timestamps feed SRT/VTT even without
    timestamp-token decoding."""
    segments: list[dict] = []
    cur_words: list = []
    for w in words:
        if cur_words and (
                w.start - cur_words[-1].end > max_gap_s
                or sum(len(x.word) for x in cur_words) + len(w.word)
                > max_len_chars):
            segments.append({"start": cur_words[0].start,
                             "end": cur_words[-1].end,
                             "text": "".join(x.word for x in cur_words)})
            cur_words = []
        cur_words.append(w)
    if cur_words:
        segments.append({"start": cur_words[0].start,
                         "end": cur_words[-1].end,
                         "text": "".join(x.word for x in cur_words)})
    return segments
