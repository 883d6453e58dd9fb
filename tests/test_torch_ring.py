"""The commit groups of the port's GPP ring (`gpp::run_chunk_schedule`,
csrc/ring.cuh), on the CPU.

`_torch_parity.ring_replay` transliterates the ring's step loop: which
chunk goes out in which `cp.async` commit group, and how many groups have
landed at each step's `cp.async.wait_group`.  Groups complete in order, so
a chunk has landed by step s's wait when its group's index is below the
count landed then.  Over G = 1..6 and S = 1..9 steps this checks what the
header claims:
  * the issue order is the reference's `chunk_issue_schedule`;
  * step s's wait forces every chunk of tile s;
  * it forces nothing that step s-1 issued for a later tile (bar the step-0
    prologue's folded chunks, which the issue order puts ahead of tile 1's
    last chunk);
  * the time a chunk gets to land: at G = 3 exactly the reference's
    per-slot wait (chunk c of a tile issued C-c steps ahead gets them
    all), at G >= 4 min(C-c, 2) steps for a steady-state chunk.
"""
import pytest

from repro.kernels import gpp_matmul as jgm
from repro_torch.kernels.ref import chunk_issue_schedule

from _torch_parity import ring_replay

pytestmark = pytest.mark.tier1

RINGS = range(1, 7)
STEPS = range(1, 10)


def _chunks(G: int) -> int:
    return max(1, G - 1)


def _groups(S, G):
    """{(tile, chunk): (issue step, group)}, {step: groups landed}."""
    C = _chunks(G)
    order, _, chunk_groups, landed = ring_replay(S, G, C)
    out = {}
    for t, groups in chunk_groups.items():
        # each tile's chunks go out in increasing c (the schedule's order)
        assert len(groups) == (1 if G == 1 else C)
        for c, g in enumerate(groups):
            (at,) = order[(t, c)]
            out[(t, c)] = (at, g)
    return out, landed


def _forced_at(group: int, landed: dict) -> int:
    """The first step whose wait forces a group (None: none does)."""
    return next((s for s in sorted(landed) if group < landed[s]), None)


@pytest.mark.parametrize("S", STEPS)
@pytest.mark.parametrize("G", RINGS)
def test_issue_order_is_unchanged(G, S):
    C = _chunks(G)
    order, _, _, _ = ring_replay(S, G, C)
    assert order == chunk_issue_schedule(S, G, C)
    assert order == jgm.chunk_issue_schedule(S, G, C)


@pytest.mark.parametrize("S", STEPS)
@pytest.mark.parametrize("G", RINGS)
def test_wait_forces_every_chunk_of_its_tile(G, S):
    chunks, landed = _groups(S, G)
    assert set(t for t, _ in chunks) == set(range(S))
    for (t, c), (at, g) in chunks.items():
        assert at <= t and g < landed[t], (t, c)
    # in-order completion: what has landed never shrinks
    assert all(landed[s] <= landed[s + 1] for s in range(S - 1))


@pytest.mark.parametrize("S", STEPS)
@pytest.mark.parametrize("G", RINGS)
def test_wait_forces_nothing_issued_for_a_later_tile(G, S):
    C = _chunks(G)
    chunks, landed = _groups(S, G)
    for s in range(1, S):
        for (t, c), (at, g) in chunks.items():
            if at != s - 1 or t <= s:
                continue
            folded = at == 0 and t - C + c < 0     # the step-0 prologue
            assert (g < landed[s]) == folded, (s, t, c)


@pytest.mark.parametrize("S", STEPS)
@pytest.mark.parametrize("G", RINGS)
def test_steps_each_chunk_gets_to_land(G, S):
    C = _chunks(G)
    chunks, landed = _groups(S, G)
    for (t, c), (at, g) in chunks.items():
        got = _forced_at(g, landed) - at
        ahead = t - at                  # the reference waits at step t
        if G == 1:
            assert got == 0             # in situ: fetch, wait, compute
        elif t - C + c < 0:             # folded into the prologue
            assert at == 0 and got == min(t, 1)
        elif G == 3:
            assert got == ahead == C - c
        else:
            assert ahead == C - c and got == min(C - c, 2)


def test_g3_is_the_reference_per_slot_wait():
    # G = 3 (C = 2) over a long run: chunk 0 of every steady tile gets its
    # 2 steps, chunk 1 its 1 — the TPU kernel's sems.at[slot] wait
    chunks, landed = _groups(9, 3)
    for t in range(2, 9):
        assert [_forced_at(chunks[(t, c)][1], landed) - chunks[(t, c)][0]
                for c in range(2)] == [2, 1]
