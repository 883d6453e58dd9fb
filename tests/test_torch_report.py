"""The port's report (`repro_torch.launch.report`) against the JAX
package's `repro.launch.report` on the same dry-run JSON records: with the
port's constants set to the reference's v5e ones (its collective term
divides by ICI_BW x ICI_LINKS), `rows_from` gives the reference's rows and
`markdown_table` its text, for every arch x `cells_for` shape on both
production meshes; a failed record renders FAILED.  `sizing_table` gives
a card's memory by cell."""
import json

import pytest
import torch

from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro_torch.configs.base import cells_for
from repro_torch.launch import report
from repro_torch.models import registry

pytestmark = pytest.mark.tier1


def _records() -> list:
    g = torch.Generator().manual_seed(0)
    out = []
    for arch in registry.ARCH_NAMES:
        for shape in cells_for(registry.get_config(arch)):
            for mesh in ("16x16", "2x16x16"):
                u = torch.rand(8, generator=g, dtype=torch.float64).tolist()
                out.append({
                    "arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                    "stream_mode": "resident", "count_s": 10 * u[0],
                    "flops_per_device": 1e15 * u[0],
                    "flops_per_device_loop_aware": 1e15 * u[0],
                    "bytes_per_device": 1e11 * u[1],
                    "bytes_per_device_loop_aware": 1e13 * u[2],
                    "dot_bytes_per_device_loop_aware": 1e12 * u[3],
                    "collective_bytes_per_device": 1e11 * u[4],
                    "collective_bytes_per_device_loop_aware": 1e11 * u[4],
                    "argument_bytes": int(4e10 * u[5]),
                    "param_bytes": int(1e10 * u[5]),
                    "temp_bytes": int(4e10 * u[6]),
                    "output_bytes": int(4e10 * u[7]),
                    "alias_bytes": int(4e10 * u[7] * u[5]),
                    "hbm_bytes": int(4e10 * (u[5] + u[6] + u[7]
                                             - u[7] * u[5])),
                    "fits": True})
    out.append({"arch": "kimi-k2-1t-a32b", "shape": "train_4k",
                "mesh": "16x16", "ok": False, "count_s": 1.5,
                "error": "RuntimeError: out of patience"})
    return out


@pytest.fixture()
def path(tmp_path):
    p = tmp_path / "dryrun.json"
    p.write_text(json.dumps(_records()))
    return str(p)


def _v5e(monkeypatch):
    monkeypatch.setattr(report, "PEAK_FLOPS", jrl.PEAK_FLOPS)
    monkeypatch.setattr(report, "HBM_BW", jrl.HBM_BW)
    monkeypatch.setattr(report, "NET_BW", jrl.ICI_BW * jrl.ICI_LINKS)


@pytest.mark.parametrize("i", range(len(_records())))
def test_rows_match_reference(monkeypatch, path, i):
    _v5e(monkeypatch)
    got, want = report.rows_from(path), jreport.rows_from(path)
    assert len(got) == len(want) == len(_records())
    assert got[i] == want[i]


def test_table_matches_reference(monkeypatch, path):
    _v5e(monkeypatch)
    text = report.markdown_table(report.rows_from(path))
    assert text == jreport.markdown_table(jreport.rows_from(path))
    assert text.splitlines()[-1] == ("| kimi-k2-1t-a32b | train_4k | 16x16 "
                                     "| — | — | — | FAILED | — | — |")


def test_rows_use_h100_constants(path):
    r = report.rows_from(path)[0]
    rec = _records()[0]
    assert r["compute_s"] == rec["flops_per_device"] / 989e12
    assert r["memory_hi_s"] == rec["dot_bytes_per_device_loop_aware"] / 3.35e12
    assert r["collective_s"] == rec["collective_bytes_per_device"] / 50e9


def test_sizing_table(path):
    lines = report.sizing_table(path).splitlines()
    assert len(lines) == 2 + len(_records())
    rec = _records()[0]
    assert lines[2] == (
        f"| {rec['arch']} | {rec['shape']} | 16x16 "
        f"| {rec['param_bytes'] / 2**30:.2f} | {rec['hbm_bytes'] / 2**30:.2f} "
        f"| yes | {rec['count_s']:.1f} |")
    assert lines[-1] == ("| kimi-k2-1t-a32b | train_4k | 16x16 | — | — "
                         "| FAILED: RuntimeError: out of patience | 1.5 |")


def test_main_prints_both_tables(path, capsys):
    report.main([path])
    out = capsys.readouterr().out
    assert "(H100 SXM5 spec constants, not measured)" in out
    assert "| arch | shape | mesh | compute s |" in out
    assert "| arch | shape | mesh | params GiB | peak GiB | fits |" in out
