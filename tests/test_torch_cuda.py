"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (a CUDA kernel has no CPU mode).  No JAX here:
the card's machine runs the port alone.
"""
import math

import pytest
import torch

from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_ref,
                                     paged_attn_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", ((4, 1024, 1024), (20, 2816, 1024),
                                   (7, 1000, 1001)))
def test_gpp_matmul_matches_plain(cuda, dtype, G, shape):
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).to(dtype)
    b = torch.randn(N, generator=g, device=cuda).to(dtype)
    y = gm.gpp_matmul(x, w, bias=b, activation="silu", num_bufs=G)
    ref = dense_ref(x, w, bias=b, activation="silu")
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("G", (1, 2, 4))
def test_gpp_issue_order_is_the_chunk_schedule(cuda, G):
    x = torch.randn(4, 1024, device=cuda).bfloat16()
    w = torch.randn(1024, 512, device=cuda).bfloat16()
    got, num_k, g_used, C = gm.issue_order(x, w, G)
    assert g_used == G
    assert got == chunk_issue_schedule(num_k, G, C)


def test_gpp_int8_with_scale(cuda):
    x = torch.randn(32, 1024, device=cuda)
    w = torch.randint(-127, 128, (1024, 768), device=cuda, dtype=torch.int8)
    scale = torch.rand(768, device=cuda) * 1e-3
    y = gm.gpp_matmul(x, w, w_scale=scale, activation="gelu")
    ref = dense_ref(x, w, w_scale=scale, activation="gelu")
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify", "window",
                                  "gqa_row_splits"))
def test_paged_attention_matches_plain(cuda, dtype, case):
    B, S, positions, window, kvh = {
        "decode": (4, 1, [5, 17, 40, 100], None, 16),
        "prefill": (1, 32, [37], None, 16),
        "verify": (4, 5, [3, 30, 64, 90], None, 16),
        "window": (4, 1, [5, 17, 40, 100], 32, 16),
        # rep * S = 4 * 32 query rows per head: split over 4 CTAs
        "gqa_row_splits": (2, 32, [0, 50], 40, 4),
    }[case]
    H, hd, bs, mb, nb = 16, 64, 16, 8, 33
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    v = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    tables = torch.randint(1, nb, (B, mb), generator=g, device=cuda,
                           dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_kv_heads=kvh, scale=1 / math.sqrt(hd), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    for G in (None, 1, 2, 4):
        out = paged_attention(q, k, v, tables, pos, num_bufs=G, **kw)
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
