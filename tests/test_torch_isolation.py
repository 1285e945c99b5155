"""heat_tpu_torch stands alone: no module of it, and nothing in
``chip_smoke.py``, imports JAX or heat_tpu; importing it loads no JAX; its
entry points do not drop to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parent.parent
_SOURCES = sorted((_REPO / "heat_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "heat_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: str(p.relative_to(_REPO)))
def test_no_jax_or_heat_tpu_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in _FORBIDDEN})
    assert not bad, f"{path.name} imports {bad}"


def _run(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
                               **env})


def test_import_loads_no_jax():
    out = _run("import sys, heat_tpu_torch, heat_tpu_torch.cli, "
               "heat_tpu_torch.backends.cuda, heat_tpu_torch.ops.cuda_stencil, "
               "heat_tpu_torch.ops.cuda_lanes, heat_tpu_torch.serve, "
               "heat_tpu_torch.ops.cuda_lab, heat_tpu_torch.labs.kernel_lab, "
               "heat_tpu_torch.labs.tune_on_chip, "
               "heat_tpu_torch.backends.sharded, heat_tpu_torch.parallel.comm, "
               "heat_tpu_torch.parallel.dist, heat_tpu_torch.parallel.halo, "
               "heat_tpu_torch.parallel.mesh, heat_tpu_torch.fleet.router, "
               "heat_tpu_torch.labs.fleet_lab, "
               "heat_tpu_torch.labs.fleet_resilience_lab, "
               "heat_tpu_torch.labs.serve_lab, heat_tpu_torch.labs.serve_mega_lab, "
               "heat_tpu_torch.labs.serve_lane_kernel_lab, "
               "heat_tpu_torch.labs.lane_kernel_build_check, "
               "heat_tpu_torch.labs.prof_overhead_lab, "
               "heat_tpu_torch.analysis, heat_tpu_torch.analysis.programs, "
               "heat_tpu_torch.runtime.debug, heat_tpu_torch.machine, "
               "heat_tpu_torch.calibrate, heat_tpu_torch.viz, "
               "heat_tpu_torch.labs.exchange_lab, "
               "heat_tpu_torch.labs.recovery_lab, "
               "heat_tpu_torch.labs.chip_check, "
               "heat_tpu_torch.labs.ckpt_overlap, "
               "heat_tpu_torch.labs.overlap_ab, "
               "heat_tpu_torch.labs.collective_overhead, "
               "heat_tpu_torch.labs.weak_scaling, "
               "heat_tpu_torch.labs.sharded3d_check; "
               "print(sorted(m for m in sys.modules "
               "if m.split('.')[0] in ('jax', 'jaxlib', 'heat_tpu')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_solve_without_device_raises_on_a_cpu_only_host():
    out = _run("import heat_tpu_torch as h\n"
               "cfg = h.HeatConfig(n=8, ntime=2, backend='cuda')\n"
               "try:\n"
               "    h.solve(cfg)\n"
               "except RuntimeError as e:\n"
               "    print('raised', e)\n",
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised") and "device='cpu'" in out.stdout

