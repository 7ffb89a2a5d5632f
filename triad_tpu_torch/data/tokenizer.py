"""Self-contained WordPiece tokenizer (BERT-uncased algorithm), the
port's own copy of ``triad_tpu/data/tokenizer.py``.

Basic tokenization (clean, lowercase, strip accents, split on
punctuation and CJK), then greedy longest-match WordPiece with '##'
continuations. Given the ``distilbert-base-uncased`` vocab.txt it gives
HF's ids. Batches come out as fixed-shape padded id and mask arrays.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-uncased tokenization: basic tokenizer + WordPiece."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        pad_token: str = "[PAD]",
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.unk_id = vocab[unk_token]
        self.pad_id = vocab.get(pad_token, 0)

    # -- construction ---------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    # -- pipeline -------------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # Pad CJK chars with spaces (HF BasicTokenizer behavior).
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )
        tokens: List[str] = []
        for tok in text.split():
            if self.lowercase:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece: Optional[str] = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: int = 128) -> List[int]:
        """No special tokens, truncated (reference model.py:104-107)."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        return ids[:max_length]

    def encode_batch(
        self, texts: List[str], max_length: int = 128, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch of texts -> (ids (B, L), attention_mask (B, L)) padded to
        ``pad_to`` (defaults to max_length)."""
        L = pad_to or max_length
        encoded = [self.encode(t, max_length=min(max_length, L)) for t in texts]
        ids = np.full((len(texts), L), self.pad_id, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask
