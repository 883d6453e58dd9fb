"""The training CLI on a 2x2 mesh of gloo ranks, mirroring `tests/
test_distributed.py::TestTrainDriver`.

More than one rank runs on gloo only, as CPU processes: `python -m
repro_torch.launch.train --device cpu --arch qwen1.5-0.5b --smoke --batch
4 --seq 32 --devices 4 --mesh 2x2 --ckpt-every 3` spawns 4 ranks
(`launch.mesh.spawn_ranks`).  It runs 6 steps, then again to 9 from the
same checkpoint directory: the second run prints "resumed from step 6",
and its losses equal steps 6-8 of one 9-step run at `--devices 1` (the
mesh-less step, run here in this process) within 1e-4.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--arch", "qwen1.5-0.5b", "--smoke", "--batch",
        "4", "--seq", "32", "--ckpt-every", "3", "--lr", "0.1"]


def _run(*extra) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _losses(out: str) -> "dict[int, float]":
    return {int(s): float(v) for s, v in
            re.findall(r"^step\s+(\d+) loss\s+(\S+)", out, re.M)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ck")
    mesh = ["--devices", "4", "--mesh", "2x2", "--ckpt-dir", str(ck)]
    first = _run(*mesh, "--steps", "6")
    second = _run(*mesh, "--steps", "9")
    from repro_torch.launch import train as train_cli
    one = train_cli.main([*ARGS, "--devices", "1", "--steps", "9",
                          "--ckpt-dir", str(tmp_path_factory.mktemp("ck1"))])
    return first, second, one


def test_cli_trains_on_2x2_and_resumes(runs):
    first, second, _ = runs
    assert "mesh: {'data': 2, 'model': 2}" in first
    assert sorted(_losses(first)) == list(range(6))
    assert "resumed from step 6" in second
    assert sorted(_losses(second)) == [6, 7, 8]


def test_cli_losses_equal_one_device(runs):
    first, second, want = runs
    got = _losses(first) | _losses(second)
    assert len(want) == 9
    for s in range(9):
        assert abs(got[s] - want[s]) <= 1e-4 * max(1.0, abs(want[s])), s
