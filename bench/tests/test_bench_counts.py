"""The yardstick's FLOP and byte counts against sums worked out by hand."""
import types

import pytest
import torch

from bench.lib import counts
from bench.lib.trace import Ranges
from bench.lib.manifest import ROOT, load_json

DS = load_json(ROOT / "bench/configs/deepseek-v2-lite-16b.json")
DN = load_json(ROOT / "bench/configs/h2o-danube-1.8b.json")


def test_dense_call():
    # 2*4*8*16 FLOPs; x 4*8*2 + w 8*16*2 + y 4*16*2 bytes
    assert counts.dense_call(4, 8, 16, 2, 2, 2) == (1024.0, 448.0)
    # f32 x and y, bf16 w, an f32 bias of 16
    assert counts.dense_call(4, 8, 16, 4, 2, 4, 4) == (1024.0, 128 + 256
                                                      + 256 + 64)


def test_grouped_call():
    # 6 rows over 2 experts, (., 4) @ (4, 5): 2*6*4*5 FLOPs, 6*(8 + 10)
    # bytes of rows and 2*40 of weights
    assert counts.grouped_call(2, 6, 4, 5, 2, 2, 2) == (240.0, 188.0)
    # 3 rows can reach only 3 of 8 experts' weights
    assert counts.grouped_call(8, 3, 4, 5, 2, 2, 2) == (120.0, 54.0 + 120.0)


@pytest.mark.parametrize("window, flops, nbytes", (
    # lanes at positions 0 and 9 attend 1 and 10 keys: 2*4*(8+8)*11; q and
    # out 128 bytes each, keys 11 positions x 32 bytes
    (None, 1408.0, 608.0),
    # a window of 4: 1 and 4 keys
    (4, 640.0, 416.0)))
def test_paged_attn_decode_call(window, flops, nbytes):
    assert counts.paged_attn_call([(0, 1), (9, 1)], 4, 8, 8, 32, window, 2,
                                  2) == (flops, nbytes)


def test_paged_attn_prefill_call():
    # queries at 5, 6, 7 under a window of 4 attend 4 keys each:
    # 2*2*(4+4)*12 FLOPs; positions 2..7 read once (6 x 16 bytes), q and
    # out 48 bytes each
    assert counts.paged_attn_call([(5, 3)], 2, 4, 4, 16, 4, 2,
                                  2) == (384.0, 192.0)


def test_bound_takes_the_larger_term():
    assert counts.bound(989e12, 0.0, counts.PEAK_BF16) == 1.0
    assert counts.bound(1.0, 3.35e12, counts.PEAK_BF16) == 1.0
    assert counts.peak_for(2, 2) == counts.PEAK_BF16
    assert counts.peak_for(4, 2) == counts.PEAK_F32


@pytest.mark.parametrize("start, n, window, want", (
    (0, 5, None, 15), (2, 4, 4, 3 + 4 + 4 + 4), (10, 3, 4, 12),
    (0, 0, 4, 0)))
def test_span_attended(start, n, window, want):
    assert counts.span_attended(start, n, window) == want
    assert want == sum(counts.attended(p, window)
                       for p in range(start, start + n))


def test_deepseek_token_params():
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    dense = attn + 3 * 2048 * 10944
    moe = attn + 8 * 3 * 2048 * 1408 + 2048 * 64
    head = 102400 * 2048
    assert counts.token_params(DS) == dense + 26 * moe + head \
        == 2_451_308_544
    assert counts.attn_flops_per_position(DS) == 2 * 16 * 320 * 27


def test_danube_token_params():
    layer = 2 * 2560 * 2560 + 2 * 2560 * 640 + 3 * 2560 * 6912
    assert counts.token_params(DN) == 24 * layer + 32000 * 2560 \
        == 1_749_155_840
    assert counts.attn_flops_per_position(DN) == 2 * 32 * 160 * 24


def test_one_decode_step_of_each_config():
    # 128 lanes at position 999: 2 x weights a token + attention over 1000
    # keys (danube: the window of 4096 does not bite)
    for cfg in (DS, DN):
        want = 128 * (2.0 * counts.token_params(cfg)
                      + counts.attn_flops_per_position(cfg) * 1000)
        assert counts.serve_flops_spans(cfg, [(999, 1)] * 128) == want
    # past the window danube attends 4096 keys
    assert counts.serve_flops_spans(DN, [(6000, 1)]) == \
        2.0 * counts.token_params(DN) \
        + counts.attn_flops_per_position(DN) * 4096


def test_one_train_step():
    # 2 x 4096 tokens: 6 x weights x tokens + 3 x the causal forward
    # attention (every query of a 4096 window sees all earlier keys)
    att = 2 * (4096 * 4097 // 2)
    assert counts.train_flops(DN, 2, 4096) == \
        6.0 * counts.token_params(DN) * 8192 \
        + 3.0 * counts.attn_flops_per_position(DN) * att


BF = torch.bfloat16
CFG = types.SimpleNamespace(experts_per_token=2)


def _step_bounds(kind, rows, real, experts_rows):
    """The bounds `Ranges` counts for one serving step that runs a dense
    product, a grouped product over 4 experts holding `experts_rows` rows
    each, and paged attention, over `rows` token rows of which `real` hold
    work: a prefill chunk of `rows` tokens, or a decode step over `rows`
    lanes (the first `real` active)."""
    r = Ranges()
    r.recording = True
    op = lambda *a, **kw: None                        # noqa: E731
    dense, grouped, attn = (r._wrap(op, n) for n in
                            ("dense", "dense_grouped", "paged_attn"))
    pool = torch.zeros(9, 16, 2, 8, dtype=BF)

    def step(params, cfg, tokens, *rest):
        n = tokens.numel()
        x = torch.zeros(1, n, 32, dtype=BF)
        dense(x, torch.zeros(32, 48, dtype=BF))
        dense(x[:, :1], torch.zeros(32, 100, dtype=BF))   # one logits row
        grouped(torch.zeros(4, experts_rows, 32, dtype=BF),
                torch.zeros(4, 32, 24, dtype=BF))
        q = torch.zeros(1, n, 4, 8, dtype=BF) if kind == "prefill" \
            else torch.zeros(n, 1, 4, 8, dtype=BF)
        pos = torch.tensor([40]) if kind == "prefill" \
            else torch.arange(n) + 40
        attn(q, pool, pool, None, pos, window=None)

    if kind == "prefill":
        r._wrap(step, "prefill_chunk")(None, CFG, torch.zeros(1, rows),
                                       None, None, 40, real - 1)
        return r.bounds([real])
    active = torch.arange(rows) < real
    r._wrap(step, "decode_step")(None, CFG, torch.zeros(rows, 1), None,
                                 None, None, active)
    return r.bounds()


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_padding_is_not_work(kind):
    """A step padded with rows that hold no work (pad tokens of a chunk,
    idle lanes, expert slots no token was routed to) is bounded as the
    same step without them."""
    padded = _step_bounds(kind, 24, 10, 24)
    exact = _step_bounds(kind, 10, 10, 5)            # 10 tokens x top-2
    assert padded == exact
    assert all(n and b > 0 for b, n in exact.values())
    # and the count follows the real rows
    assert _step_bounds(kind, 24, 12, 24)["dense"][0] > padded["dense"][0]


def test_calls_outside_a_serving_step_count_what_they_are_given():
    r = Ranges()
    r.recording = True
    r._wrap(lambda *a, **kw: None, "dense")(torch.zeros(8, 32, dtype=BF),
                                            torch.zeros(32, 48, dtype=BF))
    want = counts.bound(*counts.dense_call(8, 32, 48, 2, 2, 2),
                        counts.PEAK_BF16)
    assert r.bounds()["dense"] == (want, 1)
