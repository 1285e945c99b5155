"""``correct`` must come out false for the control and for each fault the
cells can have, and true for the program as it is: each cell driven at a
small size on the CPU (the kernels' plain versions) with the cell's own
limits, by the harness's run with the look for a card skipped.

The control is the program's own bfloat16 path (the precision below the
configurations' float32). The faults are planted under the timed path:
a pass that returns its state unchanged, a pass that steps half of the
field and leaves the rest, the halo exchange left out, and a value
altered where it is produced."""

import time

import numpy as np
import pytest
import torch

from cellbench.harness import cellrun, spec

SMALL = {
    "pycuda_4096.solves": {
        "config": {"n": 32, "ntime": 48},
        "mix": {"distinct_ics": 2, "compare_sample": 2}},
    # the 2x2 mesh in one process (LocalComm), the stencil kernel's plain
    # version on every shard, as the card runs the kernel
    "hip_flagship.sharded_2x2": {
        "config": {"n": 48, "ntime": 40},
        "mix": {"ranks": 1, "segment_blocks": 3, "check_blocks": 2,
                "program": {"backend": "sharded", "comm": "direct",
                            "exchange": "indep", "mesh_shape": [2, 2],
                            "local_kernel": "cuda"}}},
}


def run_small(workload, dtype=None, seed=2 ** 31 + 17):
    cell = spec.resolve(workload, overrides=SMALL[workload])
    ctx = cellrun.Ctx(cell=cell, seed=seed, seconds=0.3, trace=False,
                      device=torch.device("cpu"), dtype=dtype)
    return cellrun.run(ctx, time.perf_counter())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_program_is_correct(workload):
    res = run_small(workload)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 2


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    res = run_small(workload, dtype="bfloat16")
    assert res["correct"] is False, res["compared"]


def _plant(monkeypatch, how):
    from heat_tpu_torch.ops import cuda_stencil

    real = cuda_stencil._pass

    def broken(T, r, ksteps, bounds, out=None, plain=False):
        res = real(T, r, ksteps, bounds, out=out, plain=plain)
        if how == "unchanged":
            res.copy_(T)
        elif how == "half":
            res[T.shape[0] // 2:] = T[T.shape[0] // 2:]
        elif how == "altered":
            res.view(-1)[res.numel() // 2 + T.shape[-1] // 2] += 0.5
        return res

    monkeypatch.setattr(cuda_stencil, "_pass", broken)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_broken_step_is_not_correct(monkeypatch, workload, how):
    _plant(monkeypatch, how)
    assert run_small(workload)["correct"] is False


def test_exchange_left_out_is_not_correct(monkeypatch):
    from heat_tpu_torch.backends import sharded

    monkeypatch.setattr(sharded, "halo_exchange",
                        lambda padded, comm, bc_value, width=1: padded)
    assert run_small("hip_flagship.sharded_2x2")["correct"] is False


def test_answer_altered_at_the_fetch_is_not_correct(monkeypatch):
    from heat_tpu_torch.backends import common

    real = common.host_fetch

    def altered(x):
        out = np.array(real(x))
        out[out.shape[0] // 2, out.shape[1] // 2] += 0.25
        return out

    monkeypatch.setattr(common, "host_fetch", altered)
    assert run_small("pycuda_4096.solves")["correct"] is False


def test_failed_solve_is_not_correct(monkeypatch):
    from heat_tpu_torch import backends

    real, calls = backends.solve, []

    def fails_in_the_window(*a, **k):
        calls.append(1)
        if len(calls) == 3:      # set-up's warm solve, one good, then this
            raise RuntimeError("planted failure")
        return real(*a, **k)

    monkeypatch.setattr(backends, "solve", fails_in_the_window)
    res = run_small("pycuda_4096.solves")
    assert res["failed"] == 1 and res["correct"] is False
