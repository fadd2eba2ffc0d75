"""CLIP byte-pair-encoding tokenizer.

A copy of freepose_tpu.models.tokenizer (it needs no JAX).

Self-contained replacement for open_clip's SimpleTokenizer (used by the
reference at src/pipeline/retrieval/clip.py:13,91 to embed the 2,201 LLM
scale-prior object names). Reads the standard
`bpe_simple_vocab_16e6.txt(.gz)` merges file; vocabulary layout matches CLIP:
256 byte symbols, 256 byte+'</w>' symbols, 48,894 merges, then
<start_of_text>/<end_of_text> (vocab 49,408).
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path

import numpy as np


@lru_cache()
def bytes_to_unicode() -> dict:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    def __init__(self, bpe_path: str | Path, context_length: int = 77):
        self.context_length = context_length
        path = Path(bpe_path)
        raw = gzip.open(path, "rt", encoding="utf-8").read() if path.suffix == ".gz" else path.read_text()
        merges = [tuple(line.split()) for line in raw.split("\n")[1 : 49152 - 256 - 2 + 1] if line]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict = {}
        self.pat = re.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False
            else r"""'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: list = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: list[str]) -> np.ndarray:
        """-> int32 [N, context_length] with SOT/EOT, truncated like CLIP."""
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
