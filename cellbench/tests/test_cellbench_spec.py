"""BENCHMARK.json against the benchmark's contract, every cell resolved
to its files by name, and new files found with no edit."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def test_top_level_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "cellbench/run.py"]
    assert bench["paths"] == ["cellbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, cells // 4)


def test_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"] == f"cellbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert all(not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    used = set()
    cell_names = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] not in cell_names and NAME.match(w["name"])
        cell_names.add(w["name"])
        assert w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        used.add(w["config"])
    assert used == names
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cell_names)
    metric_names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    assert "setup_s" in metric_names
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["name"] not in metric_names
        metric_names.add(m["name"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert w in cell_names and spec.reports(moves, w)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark(ROOT)["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.resolve(workload, ROOT)
    assert cell.file("configs", f"{cell.config_name}.json").is_file()
    assert cell.file("mixes", f"{cell.traffic}.json").is_file()
    assert set(cell.limits["compared"])
    assert hasattr(spec.loop(cell), "window")
    assert hasattr(spec.reference(cell), "run")
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for read in spec.readers(cell, cell.end_to_end + cell.per_layer).values():
        assert callable(read)


def test_prepared_cell_resolves_by_name():
    """The four-card flagship cell is not declared (PERF.md says why); its
    files are found by the name's convention, its chips from its mix."""
    cell = spec.resolve("hip_flagship.sharded_2x2", ROOT)
    assert cell.chips == 4 and cell.mix["loop"] == "segments"
    assert set(cell.limits["compared"]) == {"first_segment_max_abs",
                                            "last_segment_max_abs"}
    assert hasattr(spec.reference(cell), "run")
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s", "setup_s"}
    reads = spec.readers(cell, [{"name": "exchange_ms"}])
    assert callable(reads["exchange_ms"])


def test_world_of_four_ranks_on_the_cpu():
    """The flagship's mix at a small size: rank 0 starts three ranks (gloo
    on the host), the shards are gathered for the check, rank 0 prints the
    one result line and every rank ends."""
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "hip_flagship.sharded_2x2", "--seed", "4294967311", "--seconds",
         "0.5", "--device", "cpu", "--override", json.dumps(
             {"config": {"n": 48, "ntime": 40},
              "mix": {"segment_blocks": 3, "check_blocks": 2}})],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["correct"] is True and line["attempted"] >= 3
    assert out.stderr.strip().splitlines()[-1].startswith(
        "compared last_segment_max_abs")


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "cellbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_found_with_no_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files, with
    entries in BENCHMARK.json, run end to end (on the CPU) in a copy of
    the checkout; no file the copy had changes."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "heat_tpu_torch").symlink_to(ROOT / "heat_tpu_torch")
    bench = spec.load_benchmark(ROOT)
    before = _digest(tmp_path)
    base = tmp_path / "cellbench"
    cfg = json.loads((base / "configs" / "pycuda_4096.json").read_text())
    cfg.update(n=24, ntime=40, bc="ghost", bc_value=0.5)
    (base / "configs" / "tiny_ghost.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "mixes" / "solves.json").read_text())
    mix.update(distinct_ics=2, compare_sample=2, profile={"skip": 0, "units": 1})
    (base / "mixes" / "two_fields.json").write_text(json.dumps(mix))
    (base / "metrics" / "solves_done.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    (base / "cells" / "tiny_ghost.two_fields.json").write_text(json.dumps(
        {"compared": {"final_field_max_abs": {"limit": 1e-3}}}))
    bench["configs"].append({"name": "tiny_ghost", "source": "a test",
                             "file": "cellbench/configs/tiny_ghost.json",
                             "reduced": ["n"], "why": "a test"})
    bench["workloads"].append({"name": "tiny_ghost.two_fields",
                               "config": "tiny_ghost", "traffic": "two_fields",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "solves_done", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "drive loop", "moves": "points_per_s",
                               "workloads": ["tiny_ghost.two_fields"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("tiny_ghost.two_fields", tmp_path)
    assert cell.config["n"] == 24 and cell.mix["distinct_ics"] == 2
    assert "solves_done" in spec.readers(cell, cell.per_layer)
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "tiny_ghost.two_fields", "--seed", "4294967311", "--seconds", "0.5",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 1
    assert list(line)[-1] == "compared"
    assert _digest(tmp_path).items() >= before.items()


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and cellbench/: no result."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "pycuda_4096.solves",
         "--seed", "1", "--seconds", "1", "--device", "cpu"], cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "pycuda_4096.solves",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_when_the_jax_package_loads(tmp_path):
    """A loop that loads ``heat_tpu`` (here a stand-in package of that
    name) after the window: the run exits non-zero, prints no result and
    names the module."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "heat_tpu_torch").symlink_to(ROOT / "heat_tpu_torch")
    (tmp_path / "heat_tpu").mkdir()
    (tmp_path / "heat_tpu" / "__init__.py").write_text("")
    base = tmp_path / "cellbench"
    (base / "loops" / "leaky.py").write_text(
        "import importlib.util, pathlib\n"
        "_spec = importlib.util.spec_from_file_location(\n"
        "    'solves_base', pathlib.Path(__file__).with_name('solves.py'))\n"
        "_base = importlib.util.module_from_spec(_spec)\n"
        "_spec.loader.exec_module(_base)\n"
        "setup, window = _base.setup, _base.window\n"
        "def compare(ctx, st, win):\n"
        "    import heat_tpu  # noqa: F401\n"
        "    return _base.compare(ctx, st, win)\n")
    mix = json.loads((base / "mixes" / "solves.json").read_text())
    mix.update(loop="leaky", distinct_ics=1, compare_sample=1)
    (base / "mixes" / "leaky.json").write_text(json.dumps(mix))
    shutil.copy(base / "cells" / "pycuda_4096.solves.json",
                base / "cells" / "pycuda_4096.leaky.json")
    bench = spec.load_benchmark(ROOT)
    bench["workloads"].append({"name": "pycuda_4096.leaky",
                               "config": "pycuda_4096", "traffic": "leaky",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "pycuda_4096.leaky",
         "--seed", "3", "--seconds", "0.2", "--device", "cpu", "--override",
         json.dumps({"config": {"n": 16, "ntime": 8}})], cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "heat_tpu" in out.stderr.strip().splitlines()[-1]
