"""The port's token pipeline (`repro_torch.data.pipeline`) against the JAX
package's on the CPU: `batch_at` gives the reference's bits for several
seeds, steps and shards, on a token arch and on both modality stubs
(musicgen's frame embeddings, llama-3.2-vision's patch embeddings); the
prefetch iterator equals direct calls, also from a resumed step; labels
are the next tokens; `make_batch_specs` has the reference's shapes."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import registry as jregistry
from repro_torch.data.pipeline import (DataConfig, TokenPipeline,
                                       make_batch_specs)
from repro_torch.models import registry

pytestmark = pytest.mark.tier1

ARCHS = ("qwen1.5-0.5b", "musicgen-large", "llama-3.2-vision-11b")


def _pair(arch: str, **data):
    d = dict(batch=3, seq_len=12, **data)
    return (TokenPipeline(registry.get_config(arch, smoke=True),
                          DataConfig(**d)),
            jpipe.TokenPipeline(jregistry.get_config(arch, smoke=True),
                                jpipe.DataConfig(**d)))


def _same_bits(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,shard", ((1234, 0), (7, 1), (0, 3)))
def test_batch_at_is_the_reference_bits(arch, seed, shard):
    port, ref = _pair(arch, seed=seed, shard_index=shard, num_shards=4)
    for step in (0, 1, 17, 100_000):
        _same_bits(port.batch_at(step), ref.batch_at(step))


def test_prefetch_iterator_equals_direct_calls():
    port, _ = _pair("qwen1.5-0.5b", seed=3, prefetch=2)
    for start in (0, 5):
        pipe = TokenPipeline(port.cfg, port.data).start(start)
        try:
            got = [next(pipe) for _ in range(4)]
        finally:
            pipe.stop()
        assert pipe._thread is None
        for i, b in enumerate(got):
            _same_bits(b, port.batch_at(start + i))
    # without the thread, next() materializes in order
    plain = iter(TokenPipeline(port.cfg, port.data))
    _same_bits(next(plain), port.batch_at(0))
    _same_bits(next(plain), port.batch_at(1))


def test_labels_are_the_next_tokens():
    port, _ = _pair("qwen1.5-0.5b", seed=9)
    b = port.batch_at(2)
    rng = np.random.default_rng(np.random.SeedSequence([9, 2, 0]))
    seq = (rng.zipf(1.3, size=(3, 13)) % port.cfg.vocab_size).astype(
        np.int32)
    np.testing.assert_array_equal(b["tokens"], seq[:, :-1])
    np.testing.assert_array_equal(b["labels"], seq[:, 1:])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == np.int32
    assert (b["tokens"] < port.cfg.vocab_size).all()


def test_modality_stubs():
    mg, _ = _pair("musicgen-large")
    b = mg.batch_at(0)
    assert "tokens" not in b and b["embeds"].shape == (3, 12,
                                                       mg.cfg.d_model)
    assert b["embeds"].dtype == np.float32
    vl, _ = _pair("llama-3.2-vision-11b")
    b = vl.batch_at(0)
    assert b["enc"].shape == (3, vl.cfg.encoder_tokens, vl.cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_the_reference(arch):
    got = make_batch_specs(registry.get_config(arch, smoke=True), 8, 64)
    want = jpipe.make_batch_specs(jregistry.get_config(arch, smoke=True), 8,
                                  64)
    assert got.keys() == want.keys()
    for k, s in want.items():
        assert got[k].shape == tuple(s.shape)
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype)
    assert make_batch_specs(registry.get_config(arch, smoke=True), 2, 4,
                            dtype=torch.float32)["labels"].dtype == \
        torch.int32
