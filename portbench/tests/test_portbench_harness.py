"""The harness: files found by name, a cell added as files only, the
result line, a run without a card, and the import boundaries."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from conftest import DATA, REPO, smoke_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    """A cell finds its configuration, traffic, limits, reference and
    metric readers from the names in BENCHMARK.json, and the readers
    state what BENCHMARK.json states of them."""
    from portbench import check, spec

    c = spec.load(cell, REPO)
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    entry = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert json.loads((REPO / entry["file"]).read_text()) == c.config
    assert entry["reduced"] == c.config["reduced"]
    assert entry["source"] == c.config["source"]
    assert set(c.limits["numbers"]) == set(check.NUMBERS)
    for m in c.per_layer:
        r = m["reader"]
        assert (r.LAYER, r.UNIT, r.BETTER, r.MOVES) == (
            m["layer"], m["unit"], m["better"], m["moves"])
        assert callable(r.read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" /
                f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)


def _bare_copy(tmp_path):
    """BENCHMARK.json and portbench/ alone, as a checkout's files of the
    benchmark."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_cell_metric_and_config_added_as_files_only(tmp_path):
    """In a copy, a configuration, a traffic mix, a cell's limits and a
    per-layer metric are new files, and BENCHMARK.json gains entries:
    the harness finds them all and runs the cell, with no other edit."""
    root = _bare_copy(tmp_path)
    pb = root / "portbench"
    shutil.copy(DATA / "opt-smoke.json", pb / "configs" / "opt-smoke.json")
    tr = json.loads((pb / "traffic" / "lezo-b16-s64.json").read_text())
    (pb / "traffic" / "tiny.json").write_text(json.dumps(
        dict(tr, batch=4, seq_len=16)))
    shutil.copy(pb / "limits" / "opt13b-lezo.json",
                pb / "limits" / "smoke-tiny.json")
    (pb / "metrics" / "zo.steps_timed.py").write_text(
        'LAYER = "whole step"\nUNIT = "steps"\nBETTER = "higher"\n'
        'MOVES = "train_tokens_per_s"\n\n\ndef read(r):\n'
        '    return r.timed["steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "opt-smoke", "source": "x",
                             "file": "portbench/configs/opt-smoke.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "smoke-tiny", "config": "opt-smoke",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "zo.steps_timed", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["smoke-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(REPO / 'src')!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from portbench import run, spec\n"
        f"c = spec.load('smoke-tiny', Path({str(root)!r}))\n"
        "print(json.dumps([m['name'] for m in c.per_layer]))\n"
        "r = run.run_cell(c, 2300000017, 0, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    per_layer, result = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert "zo.steps_timed" in per_layer
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}


def test_result_line_has_the_contract_keys():
    from portbench import run

    cell = smoke_cell(limits="opt13b-lezo")
    r = run.run_cell(cell, 2_300_000_017, 0, False, "cpu", time.perf_counter())
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "check"]
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] >= 0
    for v in r["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_a_run_without_a_card_fails_with_no_result(tmp_path, where):
    """No CUDA device (or, in a directory of the benchmark's files alone,
    no program either): a non-zero exit and nothing on standard output."""
    root = REPO if where == "repo" else _bare_copy(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "2300000017", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_the_jax_package_or_chip_smoke():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, f"{f} imports {bad}"
        if "reference" in f.parts:
            assert "repro_torch" not in set(_imports(f)), f


def test_a_run_loads_none_of_them():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
        f"sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import smoke_cell\n"
        "from portbench import run\n"
        "run.run_cell(smoke_cell(limits='opt13b-lezo'), 2300000017, 0, False,"
        " 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        f" & set({sorted(FORBIDDEN)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
