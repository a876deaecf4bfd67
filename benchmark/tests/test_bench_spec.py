"""BENCHMARK.json against the benchmark's contract, and every name in it
leading to its file: configurations, traffic mixes, check limits and the
per-layer metrics' readers."""

import json
import re

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness.spec import ROOT, Spec, load_reader, load_reference, reader_path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return Spec()


def test_top_level_keys(spec):
    bench = spec.bench
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["benchmark"]
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") for w in bench["command"])


def test_names_units_and_entries(spec):
    bench = spec.bench
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            assert set(e) == keys, e["name"]
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in bench["workloads"]:
        assert e["chips"] in (1, 4) and e["config"] in spec.configs
        assert NAME.match(e["traffic"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(spec):
    for cell in spec.cells:
        e2e = [m["name"] for m in spec.end_to_end(cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(cell)
        for m in spec.per_layer(cell):
            assert m["moves"] in e2e, (cell, m["name"])


def test_cells_find_their_files_by_name(spec):
    for cell, entry in spec.cells.items():
        config = spec.config(entry["config"])
        assert config["name"] == entry["config"]
        assert (ROOT / spec.configs[entry["config"]]["file"]).is_relative_to(ROOT / "benchmark")
        ref = load_reference(config["reference"])
        for attr in ("Model", "parameters", "kernel_work", "model_flops"):
            assert hasattr(ref, attr), (config["reference"], attr)
        mix = spec.traffic(entry["traffic"])
        assert mix["kind"] in ("train", "forecast")
        limits = spec.limits(cell)
        assert limits and all(v > 0 for v in limits.values())
        for m in spec.per_layer(cell):
            assert callable(load_reader(m["name"]))


def test_reader_lookup_order(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    for stem in ("roofline", "eager_ms", "x_roofline.train"):
        (tmp_path / "metrics" / f"{stem}.py").write_text("def read(r, name):\n    return 1.0\n")
    monkeypatch.setattr(spec_mod, "HERE", tmp_path)
    assert reader_path("x_roofline.train").name == "x_roofline.train.py"
    assert reader_path("legmm_roofline.train").name == "roofline.py"
    assert reader_path("eager_ms.serve").name == "eager_ms.py"
    with pytest.raises(FileNotFoundError):
        reader_path("nothing_here.train")


@pytest.mark.parametrize("name", ["sfno_flagship", "afno_v2"])
def test_config_holds_the_yaml_config_as_run(spec, name):
    from makani_tpu_torch.utils.yparams import YParams
    config = spec.config(name)
    want = YParams(str(ROOT / config["yaml"]), config["config"]).to_dict()
    want.pop("_yaml_filename", None)
    want.pop("_config_name", None)
    want.update(config["overrides"])
    assert json.loads(json.dumps(want)) == config["params"]
    assert config["reduced"] == spec.configs[name]["reduced"] == []
    assert config["source"] == spec.configs[name]["source"]
