"""Multi-process sharded runs: ``DistComm`` over gloo, and ``launch``.

Workers are the port's own CLI in fresh processes, started by torchrun
(``torch.distributed.run``, which ``launch`` runs) with its variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...). Each
worker's ``PYTHONPATH`` starts with a ``sitecustomize`` that refuses any
import of ``jax`` or ``heat_tpu``, so a worker that reaches for either
fails. One 2-process world runs several configurations in turn (its
start-up is paid once); their per-rank ``soln#####.dat`` files must be the
files ``--virtual-devices 2`` writes in one process, and, for a kernel
run, the reference's ``write_soln_blocks`` files from heat_tpu's sharded
solve.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu.config as ref_config
from heat_tpu.backends import solve as ref_solve
from heat_tpu.grid import coords as ref_coords
from heat_tpu.io import write_soln_blocks as ref_write_soln_blocks
from heat_tpu_torch import cli
from heat_tpu_torch.parallel import dist as port_dist

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent
_BLOCKER = '''import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "heat_tpu"):
            raise ImportError(f"a heat_tpu_torch worker imported {name}")
        return None


sys.meta_path.insert(0, _Refuse())
'''
# each rank runs every configuration through cli.main in its own directory
_WORKER = '''import json, os, sys
from heat_tpu_torch import cli
rcs = []
for i, argv in enumerate(json.loads(sys.argv[1])):
    os.chdir(os.path.join(sys.argv[2], str(i)))
    rcs.append(cli.main(argv))
if os.environ["RANK"] == "0":
    print("RCS", json.dumps(rcs))
'''
_COMMON = ["run", "--backend", "sharded", "--device", "cpu", "--soln",
           "--report-sum", "--json", "--heartbeat-every", "0"]
# (input.dat, arguments): the world's configurations
_CONFIGS = [
    ("24 0.2 0.05 2.0 13 1", ["--comm", "staged", "--mesh", "2x1", "--bc",
                              "ghost", "--ic", "hat", "--local-kernel", "cuda"]),
    ("24 0.1 0.05 2.0 13 1", ["--comm", "direct", "--mesh", "1x2", "--bc",
                              "periodic", "--dtype", "bfloat16",
                              "--local-kernel", "cuda"]),
    ("16 0.15 0.05 2.0 9 1", ["--comm", "direct", "--ndim", "3", "--mesh",
                              "2x1x1", "--bc", "edges", "--local-kernel",
                              "torch", "--exchange", "seq"]),
    ("24 0.25 0.05 2.0 7 1", ["--comm", "staged", "--mesh", "2x1", "--bc",
                              "edges", "--parity-order"]),
    ("24 0.2 0.05 2.0 13 1", ["--comm", "direct", "--mesh", "2x1", "--bc",
                              "edges", "--dtype", "bfloat16", "--local-kernel",
                              "cuda", "--exchange", "overlap"]),
    ("16 0.15 0.05 2.0 9 1", ["--comm", "staged", "--ndim", "3", "--mesh",
                              "1x2x1", "--bc", "ghost", "--local-kernel",
                              "cuda", "--exchange", "overlap"]),
]


def _env(tmp_path: Path, **extra) -> dict:
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(_BLOCKER)
    return {**os.environ, "HOME": str(tmp_path), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": f"{site}{os.pathsep}{_REPO}", **extra}


def _dirs(root: Path, configs) -> None:
    for i, (dat, _) in enumerate(configs):
        (root / str(i)).mkdir(parents=True)
        (root / str(i) / "input.dat").write_text(dat + "\n")


def _in_process(root: Path, configs) -> list:
    """The same configurations with --virtual-devices 2, in this process;
    returns each run's JSON record."""
    _dirs(root, configs)
    recs = []
    cwd = os.getcwd()
    try:
        for i, (_, args) in enumerate(configs):
            os.chdir(root / str(i))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(_COMMON + args + ["--virtual-devices", "2"]) == 0
            recs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    finally:
        os.chdir(cwd)
    return recs


def _same_files(a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.glob("soln*.dat"))
    assert names == sorted(p.name for p in b.glob("soln*.dat"))
    assert "soln00001.dat" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_world_runs_configs_like_one_process(tmp_path):
    world = tmp_path / "world"
    _dirs(world, _CONFIGS)
    ck = len(_CONFIGS)
    # a checkpointed run (shard files, one per rank and step), then the
    # same run again in its own directory, resuming from those files
    ckpt = ["--checkpoint-every", "5", "--async-io", "off",
            "--checkpoint-dir", str(world / str(ck) / "ckpt")]
    argv = json.dumps([_COMMON + args for _, args in _CONFIGS]
                      + [_COMMON + ckpt] * 2)
    for i in (ck, ck + 1):
        (world / str(i)).mkdir()
        (world / str(i) / "input.dat").write_text(_CONFIGS[0][0])
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", str(worker), argv, str(world)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    out = proc.stdout
    rcs = json.loads(out.split("RCS ")[-1])
    assert rcs == [0] * (len(_CONFIGS) + 2)
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    local = _in_process(tmp_path / "local", _CONFIGS)
    for i, (rec, want) in enumerate(zip(recs, local)):
        _same_files(world / str(i), tmp_path / "local" / str(i))
        assert rec["gsum"] == want["gsum"] and rec["mesh"] == want["mesh"]
        assert rec["kf"] == want["kf"]
    # the checkpointed world: each rank's shard file holds its block of
    # the one-process run's global checkpoint; the resumed run (from step
    # 10 of 13) writes the one-process run's files
    one = tmp_path / "one"
    _in_process(one, [(_CONFIGS[0][0], ["--checkpoint-every", "5"])])
    assert "resumed from shard checkpoints at step 10" in out
    for step in (5, 10):
        with np.load(one / "0" / "checkpoints"
                     / f"heat_step{step:08d}.npz") as z:
            whole = z["T"]
        for proc_ in (0, 1):
            name = f"heat_shards_step{step:08d}.proc{proc_:04d}.npz"
            with np.load(world / str(ck) / "ckpt" / name) as z:
                assert int(z["step"]) == step
                start = tuple(z["shard0_start"])
                data = z["shard0_data"]
                assert "shard1_data" not in z
            blk = tuple(slice(s, s + e) for s, e in zip(start, data.shape))
            assert data.tobytes() == whole[blk].tobytes()
    _same_files(world / str(ck), one / "0")
    _same_files(world / str(ck + 1), one / "0")
    assert recs[ck]["gsum"] == recs[ck + 1]["gsum"]
    # the kernel run: the reference's per-shard files of its pallas run
    ref = tmp_path / "ref"
    cfg = ref_config.HeatConfig(n=24, sigma=0.2, ntime=13, bc="ghost", ic="hat",
                                dtype="float32", backend="sharded",
                                mesh_shape=(2, 1), local_kernel="pallas")
    with contextlib.redirect_stdout(io.StringIO()):
        res = ref_solve(cfg)
    ref_write_soln_blocks(ref, ref_coords(cfg), np.asarray(res.T), (2, 1))
    for name in ("soln00000.dat", "soln00001.dat"):
        assert (world / "0" / name).read_bytes() == (ref / name).read_bytes()


def _launch(tmp_path, *argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "launch", *argv],
        cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
        timeout=timeout)


def test_launch_runs_a_world(tmp_path):
    dat, args = _CONFIGS[0]
    (tmp_path / "input.dat").write_text(dat + "\n")
    out = _launch(tmp_path, "-n", "2", "--", *_COMMON, *args)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "process 1" in out.stdout  # rank 0 announces rank 1's shard
    _in_process(tmp_path / "local", _CONFIGS[:1])
    _same_files(tmp_path, tmp_path / "local" / "0")


def test_launch_worker_failure_propagates(tmp_path):
    """A worker that dies takes the world down: the survivor, blocked in
    the exchange, is stopped, and launch returns the dead worker's code."""
    (tmp_path / "input.dat").write_text("24 0.2 0.05 2.0 100000 0\n")
    out = _launch(tmp_path, "-n", "2", "--max-restarts", "0", "--", "run",
                  "--backend", "sharded", "--device", "cpu", "--comm",
                  "staged", "--heartbeat-every", "1", "--inject",
                  "crash@3:proc=1")
    assert out.returncode == 43, (out.stdout, out.stderr)
    assert "worker 1 exited rc=43" in out.stderr


def test_launch_usage_and_deadline(tmp_path):
    # the workers' import guard is live: importing the reference fails
    guard = subprocess.run([sys.executable, "-c", "import heat_tpu"],
                           env=_env(tmp_path), capture_output=True, text=True)
    assert guard.returncode != 0 and "worker imported heat_tpu" in guard.stderr
    for argv in (["-n", "2"], ["-n", "2", "--"]):
        out = _launch(tmp_path, *argv)
        assert out.returncode == 2 and "missing worker arguments" in out.stderr
    (tmp_path / "input.dat").write_text("64 0.2 0.05 2.0 10000000 0\n")
    out = _launch(tmp_path, "-n", "1", "--deadline", "1", "--", "run",
                  "--backend", "sharded", "--device", "cpu")
    assert out.returncode == 124 and "deadline" in out.stderr


def test_direct_refuses_ranks_sharing_a_card(monkeypatch):
    """NCCL puts one rank on one GPU: a direct exchange with more ranks
    than cards on the host raises, naming what runs instead."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--comm staged.*--virtual-devices"):
        port_dist.init_distributed(torch.device("cuda"), "direct")


def _reference_restart_keys() -> list:
    """The keys of heat_tpu's ``launch_restart`` record, read from its
    supervisor's source (``heat_tpu/cli.py``) without running it."""
    import ast

    tree = ast.parse((_REPO / "heat_tpu" / "cli.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(v, ast.Constant) and v.value == "launch_restart"
                for v in node.values):
            return [k.value for k in node.keys]
    raise AssertionError("no launch_restart record in heat_tpu/cli.py")


def test_launch_restarts_a_crashed_world(tmp_path):
    """A worker crashed at the 24-step boundary (before that boundary's
    checkpoint) is restarted once; the world resumes from the shard files
    of step 16 and writes the uninterrupted world's files and sum."""
    args = ["--", *_COMMON, "--comm", "staged", "--mesh", "2x1",
            "--checkpoint-every", "8", "--async-io", "off"]
    runs = {}
    for key, extra in (("clean", []), ("crash", ["--inject", "crash@20:proc=1"])):
        where = tmp_path / key
        where.mkdir()
        (where / "input.dat").write_text("24 0.2 0.05 2.0 40 1\n")
        runs[key] = subprocess.run(
            [sys.executable, "-m", "heat_tpu_torch", "launch", "-n", "2",
             "--max-restarts", "2", *args, *extra],
            cwd=where, env=_env(tmp_path, HEAT_TPU_RESTART_BACKOFF_S="0.05"),
            capture_output=True, text=True, timeout=240)
        assert runs[key].returncode == 0, (runs[key].stdout, runs[key].stderr)
    _same_files(tmp_path / "crash", tmp_path / "clean")
    gsum = [json.loads(runs[k].stdout.strip().splitlines()[-1])["gsum"]
            for k in ("clean", "crash")]
    assert gsum[0] == gsum[1]
    err = runs["crash"].stderr
    assert "launch: worker 1 exited rc=43" in err
    recs = [json.loads(line.split("launch: restart ", 1)[1])
            for line in err.splitlines() if line.startswith("launch: restart ")]
    assert len(recs) == 1
    assert list(recs[0]) == _reference_restart_keys()
    assert recs[0]["event"] == "launch_restart" and recs[0]["attempt"] == 1
    assert recs[0]["resume_step"] == 16 and recs[0]["rc"] == 43
    assert "resumed from shard checkpoints at step 16" in runs["crash"].stdout
    assert "launch_restart" not in runs["clean"].stderr


def test_launch_gives_up_after_the_budget(tmp_path):
    """A crash in every incarnation spends the budget: launch keeps the
    worker's exit code, after one restart record per attempt."""
    (tmp_path / "input.dat").write_text("24 0.2 0.05 2.0 40 1\n")
    out = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "launch", "-n", "2",
         "--max-restarts", "1", "--", *_COMMON, "--comm", "staged",
         "--checkpoint-every", "8", "--async-io", "off", "--inject",
         "crash@20:proc=1:restart=-1"],
        cwd=tmp_path, env=_env(tmp_path, HEAT_TPU_RESTART_BACKOFF_S="0.05"),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 43, (out.stdout, out.stderr)
    assert out.stderr.count("launch: restart ") == 1
    assert "giving up after 1 restart(s)" in out.stderr
