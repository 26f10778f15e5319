"""The manifest meets the benchmark's rules, and every part of a cell is
found by name."""
import json
import re

import pytest

from bench.harness import manifest as mf

BENCH = mf.load()


def test_manifest_is_valid():
    assert mf.validate(BENCH) == []


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_names_units_and_readers(kind):
    for m in BENCH[kind]:
        assert mf.NAME.match(m["name"]) and mf.UNIT.match(m["unit"])
        assert callable(mf.metric_module(m["name"]).read)


def test_each_cell_finds_its_parts_by_name():
    for w in BENCH["workloads"]:
        config = mf.load_config(BENCH, w["config"])
        family = mf.family(config)
        assert callable(family.make_weights) and callable(family.build)
        assert mf.kind(mf.load_traffic(w["traffic"])).Session
        check = mf.load_check(w["name"])
        assert check["limits"] and check["control"] in ("tf32",)


def test_a_mix_of_an_unknown_kind_is_refused_by_name(tmp_path):
    mix = {"kind": "no_such_kind"}
    with pytest.raises(ModuleNotFoundError, match="bench.kinds.no_such_kind"):
        mf.kind(mix)
    bad = dict(BENCH, workloads=[dict(w, traffic="no_such_mix") for w in BENCH["workloads"]])
    assert any("no traffic file" in b for b in mf.validate(bad))


def test_moves_names_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in mf.metrics_for(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.metrics_for(BENCH, w["name"], "per_layer")


def test_limits_of_the_contract():
    assert BENCH["command"][1].startswith("bench/") and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert mf.seconds_budget(BENCH)["seconds"] <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_no_reduced_key_is_a_width():
    width = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head_size|expan|per_tok")
    for c in BENCH["configs"]:
        cfg = mf.load_config(BENCH, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if width.search(k)]
        assert all(k in cfg for k in c["reduced"])


def test_a_metric_is_left_out_when_its_reader_finds_nothing():
    class Empty:
        trace = None
        peaks = None
        records = []
    for m in BENCH["per_layer"]:
        assert mf.metric_module(m["name"]).read(Empty()) is None
