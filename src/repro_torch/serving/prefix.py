"""Prompt-lookup self-drafting for speculative decoding.

`ngram_propose` is a copy of `repro.serving.prefix.ngram_propose`; the
radix-tree prefix cache of that module comes with a later slice.
"""
from __future__ import annotations

import numpy as np

_NO_DRAFT = np.zeros((0,), np.int32)


def ngram_propose(tokens, k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Find the LATEST earlier occurrence of the sequence's own trailing
    n-gram (longest n first) and propose the up-to-`k` tokens that followed
    it.  No weights are streamed to produce the draft.  Returns (d,) int32
    with 0 <= d <= k; empty = no draftable repetition."""
    toks = np.asarray(tokens, np.int32)
    L = int(toks.shape[0])
    if k < 1 or L < min_ngram + 1:
        return _NO_DRAFT
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pattern = toks[L - n:]
        # windows over toks[:L-1]: every occurrence has a continuation,
        # and the trailing n-gram itself (start L-n) is excluded
        windows = np.lib.stride_tricks.sliding_window_view(toks[: L - 1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if len(hits):
            i = int(hits[-1])             # last occurrence: recency wins
            return toks[i + n : i + n + k].copy()
    return _NO_DRAFT
