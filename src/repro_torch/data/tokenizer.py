"""Byte-level tokenizer (quickstart text training needs no external vocab)."""

from __future__ import annotations

from typing import List


PAD, BOS, EOS = 0, 1, 2
OFFSET = 3


def encode(text: str) -> List[int]:
    return [BOS] + [b + OFFSET for b in text.encode("utf-8")] + [EOS]


def decode(ids) -> str:
    bs = bytes(int(i) - OFFSET for i in ids if int(i) >= OFFSET)
    return bs.decode("utf-8", errors="replace")


VOCAB = 256 + OFFSET
