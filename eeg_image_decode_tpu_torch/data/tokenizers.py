"""CLIP's byte-level BPE tokenizer and BERT's WordPiece tokenizer
(counterpart of ``eeg_image_decode_tpu/data/tokenizers.py``:
``bytes_to_unicode``, ``_whitespace_clean``, ``CLIPBPETokenizer`` and
``WordPieceTokenizer``, copied as they are).

Pure Python; the vocabularies load from the standard checkpoint files
(``vocab.json`` / ``merges.txt`` for BPE, ``vocab.txt`` for WordPiece, the
GIT captioner's). Batched output is a fixed-length int32 numpy array,
padded with ``pad_id``.
"""

from __future__ import annotations

import functools
import json
import unicodedata

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


# ———————————————————————————— WordPiece (BERT/GIT) ————————————————————————————


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-style tokenizer (basic split + WordPiece) for GIT captions.

    Mirrors ``transformers.BertTokenizer`` with its defaults
    (``do_lower_case=True``, accent stripping, greedy longest-match-first
    WordPiece with ``##`` continuations); vocab loads from ``vocab.txt``.
    """

    def __init__(self, vocab: list[str] | dict[str, int], *,
                 do_lower_case: bool = True, max_input_chars_per_word: int = 100):
        if isinstance(vocab, dict):
            self.vocab = dict(vocab)
        else:
            self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_chars = max_input_chars_per_word
        self.unk_token = "[UNK]"
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab.get("[PAD]", 0)

    @classmethod
    def from_file(cls, vocab_file: str, **kw) -> "WordPieceTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, **kw)

    # — basic tokenization —
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            out.append(" " if ch in (" ", "\t", "\n", "\r") or
                       unicodedata.category(ch) == "Zs" else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = "".join(
            f" {ch} " if _is_chinese_char(ord(ch)) else ch for ch in text
        )
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(
                    ch for ch in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(ch) != "Mn"
                )
            # split on punctuation
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in self._basic_tokenize(text):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, *, max_length: int | None = None) -> list[int]:
        """[CLS] + WordPiece ids + [SEP] (BERT single-sequence format)."""
        ids = [self.vocab.get(t, self.vocab[self.unk_token])
               for t in self.tokenize(text)]
        ids = [self.cls_id] + ids + [self.sep_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids

    def __call__(self, texts: str | list[str], *, max_length: int = 64
                 ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length=max_length)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        toks = []
        for i in ids:
            tok = self.ids_to_tokens.get(int(i), self.unk_token)
            if tok in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            toks.append(tok)
        text = " ".join(toks).replace(" ##", "")
        return text.strip()
