"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, generator and per-layer reader is found by name, names and
units keep to the allowed characters, and a cell made of data alone is
picked up and runs."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_entries_have_exactly_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])


def test_metrics_bounds_and_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in cells:
        reported = harness.metrics_of(bench, w, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.metrics_of(bench, w, True)


def test_every_part_is_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        cell, conf, config, mix, gen = harness.cell_parts(bench, w["name"])
        used.add(conf["name"])
        assert callable(gen.run)
        assert config["name"] == conf["name"]
        assert set(mix["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
        for m in harness.metrics_of(bench, w["name"], True):
            path = os.path.join(harness.HERE, "metrics", m["name"] + ".py")
            mod = harness.load_module(path, "m_" + m["name"].replace(".", "_"))
            assert callable(mod.read)
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_a_cell_of_data_alone_is_picked_up(bench, tmp_path, monkeypatch,
                                           capsys):
    """A copy of the benchmark with one more cell, whose traffic mix is a
    new data file for an existing generator: the harness finds and runs it
    with no code changed."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark")
    with open(root / "benchmark" / "traffic" / "bbox-preview.json") as f:
        mix = json.load(f)
    mix["trace_edits"] = 2
    with open(root / "benchmark" / "traffic" / "bbox2-preview.json", "w") as f:
        json.dump(mix, f)
    extra = json.loads(json.dumps(bench))
    extra["workloads"].append({"name": "seal-bbox2-preview",
                               "config": "seal-ngp-O",
                               "traffic": "bbox2-preview", "chips": 1,
                               "why": "a data-only cell"})
    for m in extra["end_to_end"] + extra["per_layer"]:
        if "seal-bbox-preview" in m.get("workloads", []):
            m["workloads"].append("seal-bbox2-preview")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(extra, f)
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "benchmark"))
    b = harness.spec()
    cell, _, _, mix2, gen = harness.cell_parts(b, "seal-bbox2-preview")
    assert mix2["trace_edits"] == 2 and gen.__file__.startswith(str(root))
    names = {m["name"] for m in harness.metrics_of(b, "seal-bbox2-preview",
                                                   True)}
    assert {"k3_roofline.preview", "k2_roofline.preview"} <= names
    from benchmark.tests.conftest import run_tiny

    line = run_tiny("seal-bbox2-preview", bench=b, capsys=capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"preview_s", "setup_s"}


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, every generator and every reader, imported in a fresh
    interpreter: no loaded module's top-level name is jax, jaxlib, flax or
    seal3d_tpu (compared whole: seal3d_tpu_torch is the port)."""
    code = (
        "import sys, os; sys.path.insert(0, os.getcwd())\n"
        "from benchmark import harness\n"
        "b = harness.spec()\n"
        "for w in b['workloads']:\n"
        "    harness.cell_parts(b, w['name'])\n"
        "    for m in harness.metrics_of(b, w['name'], True):\n"
        "        harness.load_module(os.path.join(harness.HERE, 'metrics',"
        " m['name'] + '.py'), 'x_' + m['name'].replace('.', '_'))\n"
        "import seal3d_tpu_torch.train.trainer, seal3d_tpu_torch.seal.trainer\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "seal3d_tpu_torch_fake", sys)
    assert "seal3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seal3d_tpu.ops", sys)
    assert "seal3d_tpu" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    """No CUDA device: exit code not 0 and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "seal-bbox-preview", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
