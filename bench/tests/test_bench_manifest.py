"""The loader finds configurations, cells, mixes and metric readers by the
names in BENCHMARK.json, and the manifest keeps to its format."""
import re

import pytest

from bench.lib import manifest as mf

MAN = mf.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [c["name"] for c in MAN["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    entry = mf.cell_entry(MAN, cell)
    conf, cfile, mix = mf.cell_files(MAN, cell)
    assert entry["chips"] == 1
    assert cfile["kind"] in ("serve", "train")
    assert "check" in cfile
    assert conf["bench"]["program"]["arch"] == entry["config"]
    e2e = {m["name"] for m in mf.end_to_end(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = mf.per_layer(MAN, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(mf.reader(m["name"]))


def test_configs_state_their_changes():
    for c in MAN["configs"]:
        conf = mf.load_json(mf.ROOT / c["file"])
        assert set(c["reduced"]) == set(conf["bench"]["departures"])
        assert c["source"] == conf["bench"]["source"]


def test_every_metric_reader_is_a_file_of_its_own():
    for m in MAN["per_layer"]:
        assert (mf.BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in CELLS
    moves = {m["moves"] for m in MAN["per_layer"]}
    assert moves <= {m["name"] for m in MAN["end_to_end"]}


def test_free_text_and_sizes():
    texts = [w["why"] for w in MAN["workloads"]]
    texts += [c["why"] for c in MAN["configs"]]
    texts += [c["source"] for c in MAN["configs"]]
    texts += [m["layer"] for m in MAN["per_layer"]] + MAN["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert (mf.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
