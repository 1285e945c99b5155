"""What the harness and the reference load, by whole top-level module
names: never ``jax``, ``jaxlib``, ``flax`` or ``heat_tpu`` (the JAX
package; ``heat_tpu_torch``, the program, shares its first letters and is
allowed), and for the reference nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "heat_tpu"}

HARNESS = r"""
import json, sys
sys.path.insert(0, {root!r})
from cellbench.harness import cellrun, ic, program, spec, trace, world
names = [w["name"] for w in spec.load_benchmark()["workloads"]]
for name in names + ["hip_flagship.sharded_2x2"]:
    cell = spec.resolve(name)
    mod = spec.loop(cell)
    spec.reference(cell)
    spec.readers(cell, cell.end_to_end + cell.per_layer)
    cfg = program.heat_config(cell.config, cell.mix)
import heat_tpu_torch.backends, heat_tpu_torch.backends.sharded
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import importlib.util, json, sys
from pathlib import Path
for path in sorted(Path({root!r}, "cellbench", "reference").glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "heat_tpu_torch" in names       # the program is loaded, whole name
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"heat_tpu_torch", "cellbench"})


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    from cellbench.harness import cellrun

    monkeypatch.setitem(sys.modules, "heat_tpu.config", object())
    assert cellrun.forbidden_modules() == ["heat_tpu"]
    monkeypatch.delitem(sys.modules, "heat_tpu.config")
    monkeypatch.setitem(sys.modules, "heat_tpu_torch_extra", object())
    assert cellrun.forbidden_modules() == []


def test_nothing_reads_the_jax_benchmarks():
    for path in (ROOT / "cellbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import heat_tpu\n" not in text, path
