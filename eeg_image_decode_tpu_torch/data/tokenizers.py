"""CLIP's byte-level BPE tokenizer (counterpart of
``eeg_image_decode_tpu/data/tokenizers.py``: ``bytes_to_unicode``,
``_whitespace_clean`` and ``CLIPBPETokenizer``, copied as they are).

Pure Python; the vocabulary loads from the standard checkpoint files
(``vocab.json`` / ``merges.txt``). Output is a fixed-length int32 numpy
array, padded with ``pad_id``. ``WordPieceTokenizer`` belongs to captioning
and is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import functools
import json

import numpy as np

try:  # `regex` supports \p{L}/\p{N}; it ships with transformers
    import regex as _re

    _CLIP_PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII prompts give the same ids under both patterns
    import re as _re

    # stdlib approximation: [^\W\d_] = unicode letters, \d = decimal digits
    _CLIP_PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table (BPE operates on
    strings, so raw bytes that are whitespace/control chars get remapped)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapped = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            mapped.append(256 + n)
            n += 1
    return dict(zip(printable, [chr(c) for c in mapped]))


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class CLIPBPETokenizer:
    """CLIP's lowercased byte-level BPE with ``</w>`` end-of-word markers.

    Matches ``transformers.CLIPTokenizer`` / OpenCLIP's ``SimpleTokenizer``
    token-for-token (pinned by the oracle test). Construct from the standard
    checkpoint pair via :meth:`from_files`.
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 *, context_length: int = 77, pad_token: str | None = None):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_id = self.encoder[self.bos_token]
        self.eos_id = self.encoder[self.eos_token]
        # SDXL pads tokenizer_1 with <|endoftext|> and tokenizer_2 with "!"
        self.pad_id = self.encoder[pad_token] if pad_token else self.eos_id
        self._cache: dict[str, str] = {
            self.bos_token: self.bos_token, self.eos_token: self.eos_token,
        }

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw
                   ) -> "CLIPBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # first line is the "#version" header; CLIP uses 48894 merges
        merges = [tuple(l.split()) for l in lines[1 : 49152 - 256 - 2 + 1]]
        return cls(vocab, merges, **kw)

    # — BPE core —
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if (word[i] == first and i + 1 < len(word)
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        text = _whitespace_clean(text).lower()
        pieces = []
        for token in _CLIP_PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            pieces.extend(self._bpe(token).split(" "))
        return pieces

    def encode(self, text: str) -> list[int]:
        """BOS + BPE ids + EOS, truncated to ``context_length`` (keeping the
        trailing EOS, like the hub tokenizers' ``truncation=True``)."""
        ids = [self.encoder.get(t, self.eos_id) for t in self.tokenize(text)]
        ids = [self.bos_id] + ids + [self.eos_id]
        if len(ids) > self.context_length:
            ids = ids[: self.context_length - 1] + [self.eos_id]
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        """Batch encode → (B, context_length) int32, padded with ``pad_id``."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if int(i) not in (self.bos_id, self.eos_id, self.pad_id)
        )
        raw = bytearray(self.byte_decoder[c] for c in text)
        return (
            raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
        )
