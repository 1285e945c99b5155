"""The benchmark of heat_tpu_torch: one run of one cell.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) is found by name, with its configuration, traffic
mix, compare limits and metric readers (``cellbench/harness/spec.py``).
Set-up builds the inputs from ``--seed`` and warms the cell's shapes; the
window then runs the mix for ``--seconds``; the reference checks what the
window produced; the last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the
check compared beside its limit, also the last lines of standard error).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled stretch of the window.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
3 and prints no result. A cell whose mix asks for several ranks starts
them here, one card each, and this process is rank 0.

For a rehearsal: ``--device cpu`` runs the same code on CPU tensors (the
kernels' plain versions) and writes no metric; ``--override`` replaces
top-level keys of the configuration and the mix, as JSON
``{"config": {...}, "mix": {...}}``, to run at a small size; ``--dtype``
runs the program's own path in another precision (the control);
``--seeds a,b,c`` runs one seed after the other in this process (and
world), one result line each with its seed: the readings a limit is set
from.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int)
    p.add_argument("--seeds", default=None)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--override", default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if (args.seed is None) == (args.seeds is None):
        p.error("give --seed or --seeds")
    return args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from cellbench.harness import cellrun, spec, world

    cell = spec.resolve(args.workload,
                        overrides=json.loads(args.override) if args.override
                        else None)
    ranks = int(cell.mix.get("ranks", 1))
    import torch

    if args.device == "cuda" and args.rank == 0:
        if not torch.cuda.is_available():
            print("cellbench: no CUDA card (torch.cuda.is_available() is "
                  "false)", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"cellbench: {cell.name} needs {cell.chips} cards, this "
                  f"host has {torch.cuda.device_count()}", file=sys.stderr)
            return 3
    w = None
    try:
        if ranks > 1:
            if args.rank == 0:
                w = world.World([str(Path(__file__).resolve()), *argv], ranks)
            device = world.join_world(
                args.device, cell.mix.get("program", {}).get("comm", "direct"))
        else:
            device = torch.device(args.device, 0 if args.device == "cuda"
                                  else None)
            if device.type == "cuda":
                torch.cuda.set_device(device)
        seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
                 else [args.seed])
        results = []
        for seed in seeds:
            ctx = cellrun.Ctx(cell=cell, seed=seed, seconds=args.seconds,
                              trace=bool(args.trace), device=device,
                              dtype=args.dtype)
            results.append(cellrun.run(ctx, T_START))
            if args.seeds and results[-1] is not None:
                print(json.dumps(dict(results[-1], seed=seed)), flush=True)
        if ranks > 1:
            from heat_tpu_torch.parallel.dist import leave_world

            # every rank leaves together: NCCL's teardown waits for its peers
            world.barrier()
            leave_world()
        if w is not None:
            rc = w.join()
            w = None
            if rc:
                print(f"cellbench: a rank exited rc={rc}", file=sys.stderr)
                return 1
    finally:
        if w is not None:
            w.kill()
    if results[-1] is not None and not args.seeds:
        cellrun.print_result(results[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
