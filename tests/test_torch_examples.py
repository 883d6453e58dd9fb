"""The port's examples on the CPU (`examples/torch_*.py`), beside the JAX
examples they port: the design space's printout, the serve example's
asserts and files, and the training example's resume and stream modes
(the quickstart: `test_torch_examples_quickstart.py`)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "examples")]


def _stdout(*argv) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_design_space_prints_the_reference_text():
    """Character for character, the n = 64 row and the 5.38x headline
    included."""
    ref = _stdout("examples/gpp_design_space.py")
    port = _stdout("examples/torch_gpp_design_space.py", "--device", "cpu")
    assert port == ref
    assert "    64   0.1647   0.0156   0.0308" in port
    assert "5.38x over in-situ" in port


def test_design_space_needs_the_card_unless_asked():
    import torch
    import torch_gpp_design_space as ds
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.run()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import torch_serve_batched as sb
    d = tmp_path_factory.mktemp("serve")
    return sb.run("cpu", out_dir=str(d)), d


def test_serve_rounds_hold_their_asserts(served):
    """The example's own asserts held (it returned); their figures: a prefix
    hit of at least the 32-token system prompt, speculation's streams (the
    plain run's, by the example's assert) with drafts accepted."""
    out, _ = served
    assert out["tokens"] == 8 * 12
    assert out["prefix"]["hit_rate"] > 0
    assert out["prefix"]["hit_tokens"] >= 32
    assert out["spec"]["acceptance_rate"] > 0
    assert out["spec"]["steps"] < out["spec"]["plain_steps"]


def test_serve_writes_the_obs_files(served):
    import json
    out, d = served
    trace = json.loads((d / "serve_trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    # the recorded events, after the process / thread name records
    assert len(events) >= out["obs"]["trace_events"] > 0
    snap = json.loads((d / "serve_metrics.jsonl").read_text().splitlines()[0])
    assert "ledger" in snap and "requests" in snap
    assert 0 < out["obs"]["predicted_bw_utilization"] <= 1


def test_serve_sees_at_most_three_step_shapes(served):
    out, _ = served
    for counts in out["trace_counts"].values():
        assert set(counts) <= {"prefill_chunk", "decode", "verify"}
        assert all(n <= 1 for n in counts.values())
    assert out["trace_counts"]["spec"]["verify"] == 1


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _narrow(ring_depth=3):
    import torch_train_e2e as te
    from repro_torch.core.streamer import StreamSettings
    return te.CONFIG_100M.with_(d_model=64, num_layers=3, num_heads=4,
                                num_kv_heads=2, d_ff=128, vocab_size=512,
                                stream=StreamSettings(ring_depth=ring_depth))


def _train(ckpt, steps, mode="resident", devices=0):
    import torch_train_e2e as te
    args = te.parse_args(["--steps", str(steps), "--batch", "2", "--seq",
                          "32", "--ckpt-dir", str(ckpt), "--stream-mode",
                          mode, "--device", "cpu", "--devices",
                          str(devices)])
    return te.run(args, _narrow())


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("straight"), 4)


def test_train_e2e_resume_repeats_the_straight_run(tmp_path, capsys,
                                                   straight):
    """2 steps, a save labelled 2, then a resume to 4: it starts at the
    first step not taken, and its losses at steps 2-3 are the straight
    run's bit for bit; the last checkpoint is labelled 4."""
    first = _train(tmp_path, 2)
    assert first["checkpoint"] == 2 and first["losses"] == \
        straight["losses"][:2]
    capsys.readouterr()
    resumed = _train(tmp_path, 4)
    assert "resumed at step 2" in capsys.readouterr().out
    assert resumed["start"] == 2
    assert resumed["losses"] == straight["losses"][2:]
    assert resumed["checkpoint"] == straight["checkpoint"] == 4


@pytest.mark.parametrize("mode", ("gpp", "naive_pp", "insitu"))
def test_train_e2e_stream_modes_train_resident_bits(tmp_path, mode,
                                                    straight):
    """Every streaming mode (gpp through a ring of G = 3 over 3 layers)
    trains resident's losses bit for bit."""
    assert _train(tmp_path, 4, mode)["losses"] == straight["losses"]


def test_train_e2e_prints_like_the_reference(tmp_path, capsys):
    _train(tmp_path, 3)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("params: 0.") and out[0].endswith(
        "stream: resident")
    assert out[1:] == [ln for ln in out[1:] if ln.startswith(("step ",
                                                             "loss: "))]
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] == \
        ["0", "2"]                       # every 20th step and the last
    assert out[-1].startswith("loss: ") and " -> " in out[-1]


def test_train_e2e_mid_run_checkpoint_is_labelled_with_steps_taken(
        tmp_path, monkeypatch):
    import torch_train_e2e as te
    from repro_torch.checkpoint.manager import CheckpointManager
    monkeypatch.setattr(te, "CKPT_EVERY", 2)
    _train(tmp_path, 3)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]


MESH_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {examples!r}]
import torch_train_e2e as te
from test_torch_examples import _narrow
args = te.parse_args(["--steps", "4", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", {ckpt!r}, "--device", "cpu",
                      "--devices", "4"])
print(json.dumps(te.run(args, _narrow())))
"""


def test_train_e2e_on_a_host_mesh(tmp_path, straight):
    """4 gloo ranks on a 2x2 mesh (the JAX example's (n/2, 2) rule), in a
    process of their own (gloo ranks fork, and this process may hold JAX):
    each loss within 1e-4 of the mesh-less one, relative (the
    tensor-parallel forms sum bf16 products in another order; measured
    2.5e-5)."""
    code = MESH_RUN.format(src=str(ROOT / "src"),
                           examples=str(ROOT / "examples"),
                           ckpt=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    got = json.loads(proc.stdout.splitlines()[-1])
    assert "mesh: {'data': 2, 'model': 2}" in proc.stdout
    assert got["checkpoint"] == 4
    assert all(abs(a - b) <= 1e-4 * abs(b)
               for a, b in zip(got["losses"], straight["losses"]))
