"""The control, kept as a test at a size a test run holds: at the
configurations' small widths on the CPU, the reference computed with every
weight product in float8 e4m3 reads each cell's compared numbers well
above the program's own reading (serving: the served tokens' gaps below
the reference's best; training: the loss, the first gradient and, for the
fp8 reference against the f32 one, what the step changed)."""
import pytest

from bench import control
from bench.lib import manifest as mf
from conftest import SERVE_CELLS

TRAIN = [w["name"] for w in mf.manifest()["workloads"]
         if mf.load_json(mf.BENCH / "workloads" / f"{w['name']}.json")
         ["kind"] == "train"]
SMALL = {"cell": {"check": {"requests": 4, "min_tokens": 20},
                  "init_scale": 0.2, "window_steps": 40}}


@pytest.mark.parametrize("name", list(SERVE_CELLS))
def test_serving_control_reads_above_the_program(name, bench_root):
    r = control.serve_readings(name, 2 ** 32 + 3, 1.0, "cpu", True, SMALL,
                               bench_root)
    for k in SERVE_CELLS[name][1]:
        assert r["control_" + k] > 3 * r[k], (k, r)


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_reads_above_the_program(name):
    r = control.train_readings(name, 2 ** 32 + 5, 1.0, None, "cpu", True,
                               {"mix": {"batch": 2, "seq_len": 40},
                                "cell": {"init_scale": 0.2,
                                         "window_steps": 1}})
    assert r["control"]["first_grad"] > 3 * r["program"]["first_grad"], r
