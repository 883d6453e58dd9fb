"""The traffic generator repeats by seed and draws the stated ranges."""
import numpy as np
import pytest

from bench.lib import traffic

MIXES = {
    "lognormal": {"clients": 128,
                  "prompt": {"dist": "lognormal", "median": 512,
                             "sigma": 0.7, "min": 128, "max": 2048},
                  "output": {"dist": "lognormal", "median": 128,
                             "sigma": 0.7, "min": 32, "max": 512}},
    "loguniform": {"clients": 128,
                   "prompt": {"dist": "loguniform", "min": 1024,
                              "max": 6144},
                   "output": {"dist": "loguniform", "min": 128,
                              "max": 1024}},
}


def _mix(name):
    return MIXES[name]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_stream(name):
    a = traffic.ClosedLoop(_mix(name), 2 ** 33 + 5, 1000)
    b = traffic.ClosedLoop(_mix(name), 2 ** 33 + 5, 1000)
    for _ in range(300):
        x, y = a.next(), b.next()
        assert x.max_new == y.max_new
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_the_same_lengths(name):
    mix = _mix(name)
    a = traffic.ClosedLoop(mix, 1, 50)
    b = traffic.ClosedLoop(mix, 2, 50)
    c = a.clients
    for blk in (1, 2, 5):
        la = [a.lengths(n) for n in range(blk * c, (blk + 1) * c)]
        lb = [b.lengths(n) for n in range(blk * c, (blk + 1) * c)]
        assert la != lb
        assert sorted(p for p, _ in la) == sorted(p for p, _ in lb)
        assert sorted(o for _, o in la) == sorted(o for _, o in lb)
        for p, o in la:
            assert mix["prompt"]["min"] <= p <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= o <= mix["output"]["max"]
    # the clients' first requests are already under way: residual lengths
    first_a = sorted(o for _, o in (a.lengths(n) for n in range(c)))
    assert first_a == sorted(o for _, o in (b.lengths(n) for n in range(c)))
    assert all(o >= 1 for o in first_a)
    assert sum(first_a) < sum(sorted(o for _, o in la))
    reqs = [a.next() for _ in range(c + 10)]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 50 for r in reqs)
    assert all(len(r.prompt) == a.lengths(r.index)[0] for r in reqs)


def test_quantiles():
    q = traffic.quantiles({"dist": "lognormal", "median": 512, "sigma": 0.7,
                           "min": 128, "max": 2048}, 4001)
    assert q[2000] == 512
    q = traffic.quantiles({"dist": "loguniform", "min": 100, "max": 10000},
                          1001)
    assert q[500] == 1000 and q.min() >= 100 and q.max() <= 10000


@pytest.mark.parametrize("name", MIXES)
def test_first_requests_outlast_the_fill(name):
    """With the prefill chunk given, request i of the first block asks for
    1 + the steps from the end of its prompt to the end of the last one
    (one chunk a step, oldest first) + its residual length."""
    mix = _mix(name)
    chunk = 1920
    a = traffic.ClosedLoop(mix, 2 ** 33 + 9, 50)
    b = traffic.ClosedLoop(mix, 2 ** 33 + 9, 50, chunk=chunk)
    c = a.clients
    ends = np.cumsum([-(-a.lengths(i)[0] // chunk) for i in range(c)])
    for i in range(c):
        assert b.lengths(i)[0] == a.lengths(i)[0]
        assert b.lengths(i)[1] == a.lengths(i)[1] + 1 + ends[-1] - ends[i]
    assert [b.lengths(n) for n in range(c, 3 * c)] == \
        [a.lengths(n) for n in range(c, 3 * c)]
