"""BERT WordPiece tokenizer (for GroundingDINO text prompts).

A copy of freepose_tpu.models.wordpiece (it needs no JAX).

Self-contained equivalent of the HF BertTokenizer the reference uses through
AutoProcessor for the "objects." prompt (reference
scripts/extract_proposals_ground.py:48-52). Reads a standard vocab.txt (one
token per line); basic-tokenize (lowercase, punctuation split) then greedy
longest-match-first WordPiece with '##' continuations.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab_path: str | Path, max_chars_per_word: int = 100):
        lines = Path(vocab_path).read_text(encoding="utf-8").splitlines()
        self.vocab = {tok: i for i, tok in enumerate(lines)}
        self.unk = self.vocab.get("[UNK]", 100)
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.max_chars = max_chars_per_word

    def _basic(self, text: str) -> list[str]:
        text = unicodedata.normalize("NFC", text.strip().lower())
        out: list[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif _is_punctuation(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.unk]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> list[int]:
        ids = [self.cls]
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        ids.append(self.sep)
        return ids

    def __call__(self, texts: list[str], max_length: int = 256):
        import numpy as np

        rows = [self.encode(t)[:max_length] for t in texts]
        length = max(len(r) for r in rows)
        out = np.zeros((len(rows), length), np.int64)
        mask = np.zeros((len(rows), length), np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return out, mask
