"""Deterministic sharded token pipeline (the port's copy of
`repro.data.pipeline`, numpy only).

Synthetic-corpus LM data: Zipfian token draws from a fixed PRNG lineage,
so that

  * batch i depends only on (seed, i, shard): a restarted job
    re-materializes the exact stream from its checkpointed step;
  * each host materializes only its slice of the global batch
    (shard_index / num_shards);
  * a prefetch thread keeps `prefetch` batches ready ahead of the step;
  * `embeds` / `enc` streams stand in for the audio / vision inputs.

A batch is numpy arrays with the same bits as the reference's; the
training loop moves them to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    batch: int = 8                 # per-host batch
    seq_len: int = 128
    shard_index: int = 0
    num_shards: int = 1
    prefetch: int = 2


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish token draws (realistic rank-frequency) folded into vocab."""
    z = rng.zipf(1.3, size=shape)
    return (z % vocab).astype(np.int32)


class TokenPipeline:
    """Iterator of host-local batches; deterministic in (seed, step,
    shard)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self._q: queue.Queue = queue.Queue(maxsize=max(1, data.prefetch))
        self._step = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def batch_at(self, step: int) -> dict:
        d, c = self.data, self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, d.shard_index]))
        tokens = _zipf_tokens(rng, (d.batch, d.seq_len + 1), c.vocab_size)
        out = {"labels": tokens[:, 1:]}
        if c.input_mode == "tokens":
            out["tokens"] = tokens[:, :-1]
        else:
            out["embeds"] = rng.standard_normal(
                (d.batch, d.seq_len, c.d_model), dtype=np.float32)
        if c.encoder_tokens:
            out["enc"] = rng.standard_normal(
                (d.batch, c.encoder_tokens, c.d_model), dtype=np.float32)
        return out

    def _worker(self, start_step: int):
        s = start_step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_at(s), timeout=0.1)
                s += 1
            except queue.Full:
                continue

    def start(self, start_step: int = 0):
        self._step = start_step
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            b = self.batch_at(self._step)
        else:
            b = self._q.get()
        self._step += 1
        return b

    def __iter__(self):
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                     dtype="bfloat16") -> dict:
    """Shape and dtype of each leaf of a global batch (the reference's
    `ShapeDtypeStruct` stand-ins)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = {"labels": Spec((global_batch, seq_len), torch.int32)}
    if cfg.input_mode == "tokens":
        out["tokens"] = Spec((global_batch, seq_len), torch.int32)
    else:
        out["embeds"] = Spec((global_batch, seq_len, cfg.d_model), dt)
    if cfg.encoder_tokens:
        out["enc"] = Spec((global_batch, cfg.encoder_tokens, cfg.d_model),
                          dt)
    return out
