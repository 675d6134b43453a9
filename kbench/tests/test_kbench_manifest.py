"""BENCHMARK.json and the files it names: every configuration, traffic and
metric file loads, those no cell names yet too, and every cell resolves."""
import json
import os
import re

import pytest

from kbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "kbench/run.py"]
    assert MAN["paths"] == ["kbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 << 10


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    c = harness.resolve(MAN, cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert c["traffic"]["generator"] == "metagenome"
    assert c["workload"]["chips"] in (1, 4)
    assert c["config"]["ranks"] in (1, c["workload"]["chips"])
    assert len(c["workload"]["why"]) <= 200
    e2e = [m["name"] for m in harness.metrics_of(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(MAN, cell, True)


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert os.path.isfile(os.path.join(harness.ROOT, conf["file"]))
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        body = json.load(f)
    assert body["name"] == conf["name"]
    assert body["reduced"] == conf["reduced"]
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert "guarantee" in body and "assumed" in body
    __import__("kbench.reference." + body["app"])


@pytest.mark.parametrize("m", MAN["per_layer"] + MAN["end_to_end"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] == "bases_per_s"
        mod = harness.reader(m["name"])
        assert callable(mod.value)
        for p in mod.PROBES:
            assert p["kind"] in ("host", "cuda", "mark")


def _files(kind, ext):
    return sorted(f[:-len(ext)] for f in os.listdir(
        os.path.join(harness.KBENCH, kind)) if f.endswith(ext))


@pytest.mark.parametrize("name", _files("configs", ".json"))
def test_every_config_file_loads(name):
    body = harness._json("configs", name)
    assert body["name"] == name
    assert set(body["reduced"]) <= set(body) | set(body.get("assumed", {}))
    assert set(body["reduced"]) == set(body["reduced_why"])
    assert body.get("ranks", 1) in (1, 4)
    __import__("kbench.reference." + body["app"])


@pytest.mark.parametrize("name", _files("traffic", ".json"))
def test_every_traffic_file_loads(name):
    body = harness._json("traffic", name)
    assert body["name"] == name and body["generator"] == "metagenome"
    assert set(body["reduced"]) == set(body["reduced_why"])


@pytest.mark.parametrize("name", _files("metrics", ".py"))
def test_every_reader_loads(name):
    mod = harness.reader(name)
    assert callable(mod.value)
