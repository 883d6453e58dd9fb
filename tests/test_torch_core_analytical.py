"""The port's copy of the paper's closed-form model
(`repro_torch.core.analytical`, Eqs 1-9) against the reference's
`repro.core.analytical` on the same configurations: every closed form, each
strategy, across compute-bound, matched and rewrite-bound points and
bandwidth reductions.  Floats agree within 1e-9 relative."""
import itertools

import pytest

from repro.core import analytical as jana
from repro_torch.core import analytical as ana

from _torch_parity import same_values

pytestmark = pytest.mark.tier1

FIELDS = dict(size_macro=(1024.0, 32 * 32 * 2.0), size_ou=(32.0, 16.0),
              s=(4.0, 8.0), n_in=(0.5, 2.0, 8.0, 24.0, 64.0),
              band=(16.0, 128.0, 512.0))
CONFIGS = [dict(zip(FIELDS, v)) for v in itertools.product(*FIELDS.values())]
REDUCTIONS = (1.0, 2.0, 3.0, 8.0, 64.0)


def _pair(kw):
    return ana.PimConfig(**kw), jana.PimConfig(**kw)


def test_config_and_strategies_match():
    assert ana.STRATEGIES == jana.STRATEGIES
    same_values(ana.PimConfig(), jana.PimConfig())
    c, jc = _pair(CONFIGS[7])
    for prop in ("time_rewrite", "time_pim", "ratio"):
        assert getattr(c, prop) == getattr(jc, prop)
    same_values(c.with_(n_in=3.0), jc.with_(n_in=3.0))


@pytest.mark.parametrize("fn", ("naive_pp_macro_util", "insitu_macro_util",
                                "gpp_macro_util", "naive_pp_perf_factor",
                                "macro_count_ratio", "execution_time_ratio"))
def test_per_config_forms(fn):
    for kw in CONFIGS:
        c, jc = _pair(kw)
        same_values(getattr(ana, fn)(c), getattr(jana, fn)(jc), path=fn)


@pytest.mark.parametrize("fn", ("num_macros", "per_macro_bandwidth",
                                "throughput_per_band"))
@pytest.mark.parametrize("strategy", ana.STRATEGIES)
def test_per_strategy_forms(fn, strategy):
    for kw in CONFIGS:
        c, jc = _pair(kw)
        same_values(getattr(ana, fn)(c, strategy),
                    getattr(jana, fn)(jc, strategy), path=f"{fn} {kw}")


@pytest.mark.parametrize("fn", ("insitu_perf_degradation",
                                "naive_pp_perf_degradation",
                                "gpp_perf_degradation", "gpp_adapted_point"))
def test_bandwidth_reduction_forms(fn):
    for kw, n in itertools.product(CONFIGS, REDUCTIONS):
        c, jc = _pair(kw)
        same_values(getattr(ana, fn)(c, n), getattr(jana, fn)(jc, n),
                    path=f"{fn} {kw} n={n}")


def test_unknown_strategy_raises_alike():
    c, jc = _pair(CONFIGS[0])
    for mod, cfg in ((ana, c), (jana, jc)):
        with pytest.raises((KeyError, ValueError)):
            mod.num_macros(cfg, "bogus")
