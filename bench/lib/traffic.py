"""The one traffic generator: reads a mix's parameters (a JSON file under
`bench/traffic/`) and makes the request stream of a run from its seed.

Every seed gets the same lengths: the stream is cut into blocks of
`clients` requests, and each block holds the distribution's quantiles at
(i + 0.5) / clients, for the prompts and for the outputs, in an order the
seed draws (independently, so prompt and output lengths pair at random).
The seed also draws the prompts' token ids.  So runs with different seeds
do the same work in another order, and any few hundred requests in a row
follow the distribution closely.

A closed loop of `clients` clients: request n is the n-th one submitted,
whenever a client's previous request completes.  The first block is the
clients' requests already under way when the window opens: what they have
left to produce then is a residual length, a share (i + 0.5) / clients of
a length of the block (at least one token), paired in one fixed order and
handed out in the seed's, so completions spread evenly over time.  Given
the engine's prefill `chunk`, each first request also asks for the tokens
it produces while set-up fills the lanes (one chunk a step, oldest request
first: request i gets its first token at the step that ends its prompt,
then one a step until the last prompt's), so the window opens with every
lane decoding and none of them done.

Length distributions (`prompt` and `output`):
  {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
      exp(ln m + s * z) clipped to [a, b];
  {"dist": "loguniform", "min": a, "max": b}.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray          # int32 token ids
    max_new: int


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The distribution's quantiles at (i + 0.5) / n, as whole lengths."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class ClosedLoop:
    """The request stream of one run."""

    def __init__(self, mix: dict, seed: int, vocab: int, chunk: int = 0):
        self.clients = int(mix["clients"])
        self.rng = np.random.default_rng(int(seed))
        self.prompt_q = quantiles(mix["prompt"], self.clients)
        self.output_q = quantiles(mix["output"], self.clients)
        # the first block's outputs: share (i + 0.5) / clients of a length
        # paired with it in one fixed order, the same for every seed
        share = (np.arange(self.clients) + 0.5) / self.clients
        fixed = np.random.default_rng(0).permutation(self.output_q)
        self.first_out = self.rng.permutation(
            np.maximum(1, np.ceil(share * fixed)).astype(np.int64))
        self.token_seed = int(self.rng.integers(1 << 62))
        self.vocab = int(vocab)
        self.blocks: "list[tuple[np.ndarray, np.ndarray]]" = []
        self.issued = 0
        if chunk:
            ends = np.cumsum(-(-self._block(0)[0] // int(chunk)))
            self.first_out = self.first_out + 1 + ends[-1] - ends

    def _block(self, b: int) -> "tuple[np.ndarray, np.ndarray]":
        while len(self.blocks) <= b:
            self.blocks.append((self.rng.permutation(self.prompt_q),
                                self.rng.permutation(self.output_q)))
        return self.blocks[b]

    def lengths(self, n: int) -> "tuple[int, int]":
        """(prompt length, output length) of request n."""
        prompts, outputs = self._block(n // self.clients)
        plen = int(prompts[n % self.clients])
        out = int(outputs[n % self.clients])
        if n < self.clients:
            out = int(self.first_out[n])
        return plen, out

    def request(self, n: int) -> Request:
        plen, out = self.lengths(n)
        toks = np.random.default_rng((self.token_seed, n)).integers(
            0, self.vocab, size=plen, dtype=np.int64).astype(np.int32)
        return Request(n, toks, out)

    def next(self) -> Request:
        r = self.request(self.issued)
        self.issued += 1
        return r
