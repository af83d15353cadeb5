"""The benchmark's files: BENCHMARK.json against its contract and the files
it names, and the imports of every module under portbench/."""

import ast
import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
sys.path.insert(0, ROOT)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "mioc_tpu", "bench", "benchmarks"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def modules(where=BENCH):
    for dirpath, _, files in os.walk(where):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["command"] == ["python3", "portbench/run.py"] and s["paths"] == ["portbench"]
    assert 1 <= s["run_seconds"] <= 51
    names = [c["name"] for c in s["configs"]] + [w["name"] for w in s["workloads"]]
    names += [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    assert len(json.dumps(s)) < 64 * 1024


def test_every_cell_has_its_files():
    s = spec()
    configs = {c["name"] for c in s["configs"]}
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        with open(os.path.join(BENCH, "workloads", f"{w['name']}.json")) as fh:
            cell = json.load(fh)
        assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == \
            (w["name"], w["config"], w["traffic"], w["chips"])
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["config"] for c in s["workloads"]} == configs


def test_every_metric_names_cells_that_exist_and_report_its_moves():
    s = spec()
    cells = {w["name"]: w for w in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    layers = {}
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for w in m["workloads"]:
            assert w in cells and reports(w, m["moves"])
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"], set()).add(m["name"])
    for name in cells:  # every cell reports setup_s, another end-to-end and a per-layer metric
        assert any(reports(name, k) for k in e2e if k != "setup_s")
        assert any(name in m["workloads"] for m in s["per_layer"])


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = set(top_level_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in modules(os.path.join(BENCH, "reference")):
        names = set(top_level_imports(path))
        assert "mioc_tpu_torch" not in names and "torch" not in names, path


def test_the_import_check_compares_whole_names():
    # mioc_tpu_torch begins with mioc_tpu; portbench with bench.
    assert "mioc_tpu_torch" not in FORBIDDEN and "portbench" not in FORBIDDEN
    from portbench import harness

    sys.modules.setdefault("mioc_tpu_torch_fake_probe", sys)
    try:
        assert "mioc_tpu" not in harness.loaded_forbidden()
    finally:
        del sys.modules["mioc_tpu_torch_fake_probe"]
    had = "jaxlib.fake_probe" in sys.modules
    sys.modules.setdefault("jaxlib.fake_probe", sys)
    try:
        assert "jaxlib" in harness.loaded_forbidden()
    finally:
        if not had:
            del sys.modules["jaxlib.fake_probe"]


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads"])
def test_data_files_are_json(kind):
    for fn in os.listdir(os.path.join(BENCH, kind)):
        assert fn.endswith(".json") and NAME.match(fn[:-5])
        with open(os.path.join(BENCH, kind, fn)) as fh:
            json.load(fh)
