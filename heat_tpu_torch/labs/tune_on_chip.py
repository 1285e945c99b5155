"""One-process tuning session on the card: the kernel lab's stages in
priority order, each printed as it lands.

Run: ``python -m heat_tpu_torch.labs.tune_on_chip [stage ...] [--device D]``

Stages (default ``framework lab3d lab2d thin``):

- ``framework``: the shipped path at the JAX lab's baseline shapes
  (``framework:<case>,<case>`` names cases; several concatenate);
- ``lab3d``: L1 at 512^3 f32 over Hopper tiles and depths;
- ``lab2d``: L4 at 32768^2 bf16 over tiles and depths;
- ``thin``: L3 shrink against bf16native at 16384^2 bf16.

A stage that fails (an error, or a config that cannot launch) is printed
and the next stage runs; the process then exits 1, so a session with a
failed stage never ends with 0.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from . import kernel_lab as lab

STAGES = ("framework", "lab3d", "lab2d", "thin")
# Hopper configs: (tile, steps per pass); the first of each is the shipped
# kernel's tile at the shipped depth
LAB3D = [((16, 16, 32), 8), ((16, 16, 32), 4), ((8, 16, 64), 4),
         ((8, 16, 64), 7)]
LAB2D = [((64, 96), 16), ((32, 192), 16), ((64, 96), 32), ((32, 192), 32)]
THIN = [("shrink", (64, 96), 16), ("bf16native", (64, 96), 16),
        ("shrink", (32, 192), 16), ("bf16native", (32, 192), 16)]
FRAMEWORK = ["2d4096", "3d512", "2d32k_bf16", "2d32k_f32"]


def run_stage(name: str, fw_cases, device, results: list) -> list:
    """One stage's bench rows."""
    if name == "framework":
        return lab.bench_framework([lab.FRAMEWORK_CASES[k] for k in fw_cases],
                                   device, results)
    if name == "lab3d":
        return lab.bench_3d(LAB3D, device, results)
    if name == "lab2d":
        return lab.bench_2d(LAB2D, device, results)
    return lab.bench_thin2d_variants(16384, "bfloat16", THIN, device, results)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = lab.parse_device(argv)
    stages = argv or list(STAGES)
    fw_filter = [c for s in stages if s.startswith("framework:")
                 for c in s.split(":", 1)[1].split(",")]
    unknown = [s for s in stages
               if s not in STAGES and not s.startswith("framework:")]
    unknown += [c for c in fw_filter if c not in lab.FRAMEWORK_CASES]
    if unknown:
        raise SystemExit(f"unknown stages or framework cases {unknown}; the "
                         f"stages are {list(STAGES)} and framework:<case>, "
                         f"cases {sorted(lab.FRAMEWORK_CASES)}")
    fw_cases = fw_filter or FRAMEWORK
    t_start = time.time()
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(f"device: {torch.cuda.get_device_name(device)} "
              f"({smi.stdout.strip() or 'nvidia-smi: ' + smi.stderr.strip()})",
              flush=True)
    else:
        print(f"device: {device} (the plain versions; benches fail here)",
              flush=True)

    results: list = []
    order = [s for s in STAGES if s in stages
             or (s == "framework" and fw_filter)]
    failed = []
    for name in order:
        print(f"=== stage {name} (t+{time.time() - t_start:.0f}s)", flush=True)
        try:
            rows = run_stage(name, fw_cases, device, results)
            bad = [r for r in rows if r["failed"]]
            if bad:
                failed.append(name)
                print(f"stage {name} FAILED: {len(bad)} of {len(rows)} "
                      f"configs", flush=True)
        except Exception as e:  # noqa: BLE001 — printed; rc 1 at the end
            failed.append(name)
            print(f"stage {name} FAILED: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
        # drop the stage's device buffers before the next stage allocates
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"tuning session done in {time.time() - t_start:.0f}s"
          + (f"; FAILED stages: {' '.join(failed)}" if failed else ""),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
