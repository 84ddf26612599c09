"""Whisper tokenizer: vocab-table detokenization + prompt construction
(the port's own copy of whisper_tpu/tokenizer.py, with its own copy of
the bundled table, assets/vocab.txt; tests/test_torch_config_tokenizer.py
holds the two equal).

`decode_reference()` drops `<|...|>` specials, maps `Ġ` -> space and the
literal two-character escape `\\n` -> newline, then concatenates.
`decode()` is the GPT-2 byte-level decoder: vocab entries are strings over
the GPT-2 printable-unicode alphabet; decoding maps each character back to
its byte and utf-8-decodes the byte stream.

Prompt construction builds the SOT sequence ([50258, 50259, 50359, 50363]
for tiny, English, transcribe) for any language/task/timestamp
combination across the model family.
"""

from __future__ import annotations

import functools
import os
from typing import Iterable, Optional, Sequence

from whisper_tpu_torch.config import WhisperConfig

# Whisper language codes in token-id order: <|en|> = sot+1, <|zh|> = sot+2, ...
# Verified against the reference vocab.txt lines 50260-50358 (id = line-1).
LANGUAGES: tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
    "yue",  # 100th language, large-v3 family only
)

_ASSET_VOCAB = os.path.join(os.path.dirname(__file__), "assets", "vocab.txt")


@functools.lru_cache(maxsize=4)
def _byte_decoder() -> dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode table (standard public algorithm:
    printable bytes map to themselves; the rest map to U+0100+n)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class Tokenizer:
    """Decode-first tokenizer over a whisper vocab table.

    The table format is the reference's `vocab.txt` contract: one token
    string per line, ID = line number - 1, real newlines inside tokens
    escaped as the literal two characters ``\\n``.
    """

    def __init__(self, vocab_path: Optional[str] = None,
                 config: Optional[WhisperConfig] = None):
        self.config = config
        path = vocab_path or _ASSET_VOCAB
        with open(path, encoding="utf-8") as f:
            # Token strings keep their literal \n escapes; unescaping is
            # decode-mode-dependent.
            self.tokens: list[str] = f.read().split("\n")
        if self.tokens and self.tokens[-1] == "":
            self.tokens.pop()
        if config is not None and len(self.tokens) < config.vocab_size:
            # the bundled table is the 51,865-token multilingual vocab;
            # .en and large-v3 variants need their own vocab.txt
            raise ValueError(
                f"vocab table at {path} has {len(self.tokens)} entries but "
                f"model {config.name!r} needs {config.vocab_size}; pass the "
                f"matching vocab via --vocab / vocab_path")

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # ---- reference-parity decode (tokenizer.mojo:15-28) ----
    def decode_reference(self, ids: Iterable[int]) -> str:
        out: list[str] = []
        for tid in ids:
            tok = self.tokens[int(tid)]
            if tok.startswith("<|") and tok.endswith("|>"):
                continue
            out.append(tok.replace("Ġ", " ").replace("\\n", "\n"))
        return "".join(out)

    # ---- correct GPT-2 byte-level decode ----
    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        bd = _byte_decoder()
        buf = bytearray()
        parts: list[str] = []
        for tid in ids:
            tok = self.tokens[int(tid)]
            if tok.startswith("<|") and tok.endswith("|>"):
                if skip_special:
                    continue
                if buf:
                    parts.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                parts.append(tok)
                continue
            for ch in tok.replace("\\n", "\n"):
                b = bd.get(ch)
                buf.append(b if b is not None else ord("?"))
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(parts)

    def id_to_token(self, tid: int) -> str:
        return self.tokens[int(tid)]

    # ---- encode (capability extension: the reference and this framework's
    # decode path never need one — prompt ids are constructed — but
    # initial_prompt conditioning takes user text) ----
    @functools.cached_property
    def _byte_encoder_table(self) -> dict[int, str]:
        return {b: c for c, b in _byte_decoder().items()}

    @functools.cached_property
    def _vocab_index(self) -> dict[str, int]:
        idx: dict[str, int] = {}
        for tid, tok in enumerate(self.tokens):
            if tok.startswith("<|") and tok.endswith("|>"):
                continue        # specials are never produced from user text
            idx.setdefault(tok.replace("\\n", "\n"), tid)
        return idx

    @functools.cached_property
    def _merge_ranks(self) -> dict[tuple[str, str], int]:
        """Merge table RECONSTRUCTED from vocab order (vocab.txt carries no
        merges file — neither does the reference, tokenizer.mojo:4-28 is
        decode-only). A BPE vocab lists tokens in merge-creation order, so
        each multi-unit token's producing merge is recoverable as the split
        (a, b) minimizing max(id(a), id(b)) — both halves must already
        exist when the merge fires, and the latest-created half determines
        when the token becomes constructible. This is a reconstruction
        HEURISTIC: ties and alternative splits can in principle recover a
        different pair than the true merges.txt, so encode() segmentations
        are best-effort-canonical (round-trip decode(encode(t)) == t always
        holds; only prompt-conditioning token CHOICE could differ). If a
        real merges.txt is available, prefer load_merges(); tokens with no
        in-vocab split simply get no merge."""
        vocab = self._vocab_index
        ranks: dict[tuple[str, str], int] = {}
        for tok, tid in sorted(vocab.items(), key=lambda kv: kv[1]):
            if len(tok) < 2:
                continue
            best = None
            for i in range(1, len(tok)):
                a, b = vocab.get(tok[:i]), vocab.get(tok[i:])
                if a is not None and b is not None and a < tid and b < tid:
                    key = max(a, b)
                    if best is None or key < best[0]:
                        best = (key, i)
            if best is not None:
                pair = (tok[:best[1]], tok[best[1]:])
                ranks.setdefault(pair, len(ranks))
        return ranks

    def load_merges(self, merges_path: str) -> None:
        """Replace the reconstructed merge table with a real GPT-2
        merges.txt (one "a b" pair per line, optional "#version" header,
        rank = line order). Use when checkpoint-adjacent tokenizer files are
        available — encode() then matches canonical BPE exactly rather than
        via the _merge_ranks reconstruction heuristic."""
        ranks: dict[tuple[str, str], int] = {}
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    ranks.setdefault((a, b), len(ranks))
        # overwrite the cached_property slot with the authoritative table
        self.__dict__["_merge_ranks"] = ranks

    _PRETOK = None          # compiled GPT-2 pre-tokenizer pattern (lazy)

    def encode(self, text: str) -> list[int]:
        """Canonical byte-level BPE encode: GPT-2 pre-tokenizer split, then
        lowest-rank-first pair merging under the reconstructed merge table
        (see _merge_ranks). decode(encode(t)) == t for all text; unlike
        encode_greedy, segmentations match what the model saw in training,
        which is what initial_prompt / prev-text conditioning should feed
        it. Needs the third-party `regex` module for the \\p{L} classes
        (declared in pyproject); falls back to greedy longest-match if it
        is somehow absent."""
        try:
            import regex
        except ImportError:
            return self.encode_greedy(text)
        if Tokenizer._PRETOK is None:
            Tokenizer._PRETOK = regex.compile(
                r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
        be = self._byte_encoder_table
        vocab = self._vocab_index
        ranks = self._merge_ranks
        out: list[int] = []
        for word in Tokenizer._PRETOK.findall(text):
            parts = [be.get(b, "?") for b in word.encode("utf-8")]
            while len(parts) > 1:
                pairs = [(ranks.get((parts[i], parts[i + 1]), 1 << 60), i)
                         for i in range(len(parts) - 1)]
                rank, i = min(pairs)
                if rank >= 1 << 60:
                    break
                parts[i:i + 2] = [parts[i] + parts[i + 1]]
            for p in parts:
                tid = vocab.get(p)
                if tid is not None:
                    out.append(tid)
                else:           # symbol never reached vocab: greedy rescue
                    out.extend(self._greedy_units(p))
        return out

    def _greedy_units(self, units: str) -> list[int]:
        """Longest-match greedy over an already byte-mapped unit string."""
        vocab = self._vocab_index
        out: list[int] = []
        i = 0
        max_len = max((len(t) for t in vocab), default=1)
        while i < len(units):
            for ln in range(min(max_len, len(units) - i), 0, -1):
                tid = vocab.get(units[i:i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
            else:
                i += 1          # unencodable unit: skip
        return out

    def encode_greedy(self, text: str) -> list[int]:
        """Longest-match greedy encoding over the vocab table.

        NOT canonical BPE (see encode() for that); any greedy segmentation
        decodes back to the same text, which is all prompt conditioning
        strictly needs. decode(encode_greedy(t)) == t for encodable
        text. Kept as encode()'s rescue path and for A/B."""
        be = self._byte_encoder_table
        units = "".join(be.get(b, "?") for b in text.encode("utf-8"))
        return self._greedy_units(units)


def split_segments(cfg: WhisperConfig, ids: Sequence[int],
                   tokenizer: "Tokenizer",
                   window_offset_s: float = 0.0) -> list[dict]:
    """Parse a timestamped token stream into segments.

    Timestamp tokens encode times in 0.02 s steps from <|0.00|>
    (= cfg.timestamp_begin). Returns [{"start", "end", "text", "tokens"}].
    Capability extension: the reference has no timestamp support at all
    (its prompt hardcodes <|notimestamps|>, whisper.mojo:188-191).
    """
    ts0 = cfg.timestamp_begin
    segments: list[dict] = []
    start: Optional[float] = None
    cur: list[int] = []
    for tid in ids:
        tid = int(tid)
        if tid >= ts0:
            t = window_offset_s + (tid - ts0) * 0.02
            if start is None:
                start = t
            elif cur:
                segments.append({"start": start, "end": t,
                                 "text": tokenizer.decode(cur),
                                 "tokens": list(cur)})
                start, cur = None, []
            else:
                start = t          # consecutive timestamps: new segment start
        elif tid < cfg.eot_token:
            cur.append(tid)
    if cur:
        segments.append({"start": start or window_offset_s, "end": None,
                         "text": tokenizer.decode(cur), "tokens": list(cur)})
    return segments


def language_token(cfg: WhisperConfig, language: str) -> int:
    lang = language.lower()
    try:
        idx = LANGUAGES.index(lang)
    except ValueError:
        raise ValueError(f"unknown language {language!r}") from None
    if idx >= cfg.n_languages:
        raise ValueError(f"language {language!r} not in {cfg.name}'s vocab")
    return cfg.first_language_token + idx


def build_prompt(cfg: WhisperConfig, language: str = "en",
                 task: str = "transcribe",
                 timestamps: bool = False,
                 prev_tokens: Sequence[int] = ()) -> list[int]:
    """SOT prompt sequence. For (tiny, en, transcribe, no timestamps) this is
    exactly the reference's hardcoded [50258, 50259, 50359, 50363]
    (reference whisper.mojo:188-191)."""
    ids: list[int] = []
    if prev_tokens:
        # NOT sot_token + 3 (= 50261, a LANGUAGE token): <|startofprev|>
        # sits after the task tokens at 50361 (assets/vocab.txt)
        ids.append(cfg.sot_prev_token)
        ids.extend(int(t) for t in prev_tokens)
    ids.append(cfg.sot_token)
    if cfg.multilingual:
        ids.append(language_token(cfg, language))
        if task == "transcribe":
            ids.append(cfg.transcribe_token)
        elif task == "translate":
            ids.append(cfg.translate_token)
        else:
            raise ValueError(f"unknown task {task!r}")
    if not timestamps:
        ids.append(cfg.no_timestamps_token)
    return ids
