"""BENCHMARK.json against the harness: every name finds its file."""

import json
import re
from pathlib import Path

import pytest

from slambench import check, run, scene

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert (ROOT / "slambench" / "run.py").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_config_mix_limits_and_metrics(cell):
    bench, w, cfg, mix, limits = run.load_cell(cell)
    assert w["name"] == cell
    assert cfg["name"] == w["config"]
    assert set(cfg["Config"]) <= set(
        __import__("slambench.reference.slam.state",
                   fromlist=["Config"]).Config._fields)
    assert isinstance(mix, scene.Mix)
    assert limits and set(limits) <= set(check.NUMBERS)
    for m in bench["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert callable(run.metric_reader(m["name"]))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        run.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        scene.load_mix("no-such-mix")
    with pytest.raises(FileNotFoundError):
        check.load_limits("no-such-cell")


def test_readers_return_none_on_nothing():
    rec = {"window": [], "profiled": [], "P": 768,
           "peak": {"flops": 67e12, "bytes": 3.35e12}}
    for m in BENCH["per_layer"]:
        assert run.metric_reader(m["name"])(rec) is None, m["name"]


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
