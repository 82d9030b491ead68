"""Offline-safe hash tokenizer (counterpart of `repro.data.tokenizer`).

Word-level: each whitespace token hashes into a fixed id range with the
same FNV path as the graph node ids (`core.transform.hash_str`), so ids
equal the reference's.  Deterministic across processes."""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from repro_torch.core.transform import hash_str

PAD, BOS, EOS, RESERVED = 0, 1, 2, 16


class HashTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._range = vocab_size - RESERVED

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [RESERVED + (hash_str(9, w) % self._range) for w in text.split()]
        if add_special:
            return [BOS] + ids + [EOS]
        return ids

    def encode_batch(self, texts: Iterable[str], seq_len: int) -> np.ndarray:
        """(len(texts), seq_len) int32: each text's ids, cut to seq_len
        and padded with PAD."""
        texts = list(texts)
        out = np.full((len(texts), seq_len), PAD, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[:seq_len]
            out[i, : len(ids)] = ids
        return out
