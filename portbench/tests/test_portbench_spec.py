"""BENCHMARK.json against its required form, every entry resolved to its
file by name, and the package's imports."""

import ast
import json
import re
import shutil

import pb_cases
from pb_cases import ROOT

from portbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PKG = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names += [c["name"], *c["reduced"]]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        names += [w["name"], w["config"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in SPEC[group]]
        assert len(ns) == len(set(ns)), group
    texts = [x["why"] for x in SPEC["configs"] + SPEC["workloads"]]
    texts += [c["source"] for c in SPEC["configs"]] + SPEC["command"]
    texts += [m["layer"] for m in SPEC["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_every_entry_resolves_to_its_file():
    for c in SPEC["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        conf = harness.data("configs", c["name"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (PKG / "reference" / f"{conf['reference']}.py").is_file()
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = harness.data("workloads", w["name"])
        assert cell["config"] == w["config"] in configs
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert w["traffic"] == w["name"][len(w["config"]) + 1:]
        assert (PKG / "kinds" / f"{cell['kind']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        got = {m["name"] for m in harness.cell_metrics(SPEC, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        layer = harness.cell_metrics(SPEC, w["name"], True)
        assert layer and all(m["moves"] in got for m in layer)
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])


def _modules():
    return [p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_nor_the_jax_package():
    for p in _modules():
        tops = {name.split(".")[0] for name in _imports(p)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, p
        assert "benchmarks" not in tops, p
        assert "bench" "marks/" not in p.read_text(), p


def test_reference_imports_nothing_of_the_program():
    for p in (PKG / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(p)}
        assert tops <= {"__future__", "contextlib", "math", "numpy", "torch",
                        "portbench"}, (p, tops)
        assert all(not n.startswith("portbench.") or
                   n.startswith("portbench.reference")
                   for n in _imports(p)), p


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A traffic file and a metric file added beside the others, and their
    entries in BENCHMARK.json, are all a new cell needs."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    base = json.loads((pkg / "workloads" / f"{pb_cases.DECODE}.json")
                      .read_text())
    name = "falcon-mamba-7b.decode-b8"
    new = dict(base, name=name, why="a smaller batch")
    new["traffic"] = dict(base["traffic"], batch=8)
    (pkg / "workloads" / f"{name}.json").write_text(json.dumps(new))
    (pkg / "metrics" / "batches_started.decode.py").write_text(
        "def read(rec):\n    return rec['tokens'] / rec['batch']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": name, "config": "falcon-mamba-7b",
                              "traffic": "decode-b8", "chips": 1,
                              "why": "a smaller batch"})
    for m in spec["end_to_end"]:
        if "workloads" in m and pb_cases.DECODE in m["workloads"]:
            m["workloads"].append(name)
    spec["per_layer"].append({
        "name": "batches_started.decode", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "device",
        "moves": "decode_tok_s", "workloads": [name]})
    monkeypatch.setattr(harness, "PKG", pkg)
    traffic = dict(pb_cases.TRAFFIC[pb_cases.DECODE], batch=8)
    out = harness.run_cell(name, 5, 0.3, False, device="cpu",
                           sizes=pb_cases.SIZES[pb_cases.DECODE],
                           traffic=traffic, spec=spec)
    assert set(out["metrics"]) == {"decode_tok_s", "token_gap_p95_ms",
                                   "setup_s"}
    assert out["attempted"] % 8 == 0
    assert [m["name"] for m in harness.cell_metrics(spec, name, True)][-1] \
        == "batches_started.decode"
    read = harness.reader("batches_started.decode")
    assert read({"tokens": 80, "batch": 8}) == 10
