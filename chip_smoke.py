#!/usr/bin/env python3
"""On-card smoke test of heat_tpu_torch: builds the CUDA kernels, holds them
against their plain PyTorch versions byte for byte, drives the ``run`` path
at the shipped sizes in 2D and 3D, the ``serve`` path, the fleet router over
several ``serve`` processes, the kernel lab and the ``sharded`` backend, and
checks the answer against the serial oracle.

Usage, from the repository root on a host with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a card, or outside
a checkout of the repository, it exits non-zero and prints no result):

0. right after the build, the card-only pytest cases,
   ``python -m pytest --noconftest -p no:cacheprovider -m cuda
   tests/test_torch_card.py`` (that file imports neither JAX nor
   heat_tpu): a failure or a skip fails the run;

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, the
   kernel builds (``nvcc`` for sm_90a, one process per source, started
   together, each source's time) and their ptxas register reports, with
   registers and spills of every ``ftcs2d``, ``ftcs3d``, ``lanes2d`` and
   ``lanes3d`` instance;
2. each kernel against its plain version on the card, bytes compared, all
   through the public wrappers (so in the reference's pass schedule) unless
   a single pass is named:
   ``ftcs2d`` — 67x130, 1000x4099 and 4096^2 under edges/ghost/periodic,
   f32/bf16, k in {1, 7, 16}, r in {0.25, 0.2}; one 16-step 32768^2 pass in
   f32 and bf16; single passes of k in {17, 32} at 67x130 and 4096^2;
   segment and region ends of the streamed design (segments of 16 to 256
   rows, sized per field to fill whole waves; a 128-wide region): 300x4099
   (rows not a multiple of the segment, width not a multiple of 4 or of the
   output strip) and 20x70 (fewer rows than a segment and its 2k halo)
   likewise at r 0.2; bounds inside the field (lo 3, hi size-5)
   through ``ftcs_multistep_bounded_cuda`` at 67x130 and 4096^2, k in {1,
   16, 32}, f32/bf16; NaNs planted in an interior cell and 4 rows from a
   frozen ring 41 cells wide at 1000x4099, k in {7, 16, 32} (the same NaN
   cells, the same bytes elsewhere, the NaN in the frozen ring);
   ``ftcs3d`` — 24x20x130, 67x45x129 and 256^3 under edges/ghost/periodic,
   f32/bf16, k in {1, 4, 8}, r in {1/6, 0.15}; segment ends of the
   streamed design (segments of up to 256 rows, sized to fill whole waves
   of the card): 300x40x70 (rows not a multiple of
   256) and 20x33x40 (fewer rows than 256 + 2k) likewise at r 0.15; bounds
   inside the field on every axis (lo 3, hi size-5) through
   ``ftcs_multistep_bounded_cuda`` at 67x45x129 and 256^3, k in {1, 5, 8},
   f32/bf16, r in {1/6, 0.15} (blocks whose halo meets a frozen plane);
   the inputs of ``tests/test_torch_cuda_stencil3d.py``'s card-only case
   (a CPU-seeded 67x45x129 field, k in {1, 4, 8}; pytest cannot run on the
   card's host, whose tests/conftest.py needs JAX); single 512^3 passes
   (f32 k=8, bf16 k=4) and a 1024^3 f32 k=5 pass;
   then per-pass times of kernel and plain version at the main path's
   shapes and depths, and of the 4096^2 k=32 and 512^3 f32 k=4 passes (in
   2D beside the band design, the lab's 64x96 K1-form tile, on the same
   field), the kernel's time per pass at 4096^2 f32 for k in {1, 2, 4, 8,
   16, 24, 32} and at 512^3 f32 for every depth k = 1..8;
   the lane kernels ``lanes2d`` (2D buckets 12, 256, 1024) and ``lanes3d``
   (3D buckets 8, 64, 256) through ``cuda_lanes.lane_multistep`` against
   ``plain=True``: f32/bf16, edges/ghost, k in {1, 5, 16, 37}, 4 lanes with
   their own r (one with n < B, one whose countdown ends inside the chunk,
   one with none left, one with a NaN in its centre): fields and finite bits
   byte-equal, resid/tmin/tmax equal on finite lanes, heat within a relative
   1e-5; then the streamed ``lanes2d``'s own 100 cases: L in {1, 3, 8}, B in
   {12, 128, 129, 256, 1024} (one region, 2.7 regions, rows at odd offsets,
   the main path's buckets), k in {1, 4, 15, 16, 37}, and the streamed
   ``lanes3d``'s own 140: L in {1, 3, 8}, B in {8, 32, 33, 64, 256} (a tile
   edge, a tile edge and an odd side, the main path's bucket), k in {1, 4,
   5, 8, 15, 16, 37}; both f32/bf16, both BCs, lanes in four roles (steps
   past the chunk; n < B with NaNs of a payload no kernel computes next to
   the live region's edge, on every axis in 3D, and two cells past it; a
   countdown that ends inside a pass; none left); every case also through
   the earlier design, ``heat_lanes2d_band`` / ``heat_lanes3d_step`` (the
   same bytes, NaN cells as NaN; finite bits and resid/tmin/tmax equal);
   every case in the shipped passes (of up to 8 steps in 2D, 4 in 3D) and
   again in the kernel's deepest (16 / 8); the kernels' launch geometry
   (``heat_lanes2d_geometry`` / ``heat_lanes3d_geometry``) equal to
   ``cuda_lanes.lanes2d_geometry`` / ``lanes3d_geometry`` at every depth;
   then one serving chunk of 8 lanes timed at the main path's buckets
   (``lanes2d``: two 8-step passes; ``lanes3d`` at 8x258^3 f32 and bf16,
   16 steps: four 4-step passes) beside its earlier design (the band, one
   16-step pass; one step a launch) in turns (kernel, earlier, earlier,
   kernel), the kernel in its deepest passes, both designs' device time per
   chunk from ``torch.profiler`` (back-to-back chunks of a small bucket are
   bound by the host's launches, not the card), and the ``lanes3d`` chunk
   in passes of every depth 1..8 (the sweep behind ``cuda_lanes.PASS_3D``),
   each held to the plain version's bytes;
3. the main path, ``heat_tpu_torch.cli.main(["run", "--backend", "cuda",
   "--json", ...])`` (what ``python -m heat_tpu_torch run`` calls) with the
   launch counts zeroed just before and read just after:
   2D — 4096^2 f32 for 8192 steps (the python/cuda benchmark shape),
   32768^2 in f32 and bf16 (the hip.dat size, ntime cut to 128: its plain
   version, run to compare, takes about 2.7 s a pass), each run's
   global sum equal to that of the plain version run in the same passes;
   3D (``--ndim 3``) — 512^3 f32 for 3200 steps at sigma 1/6 (the
   reference's config 4, benchmarks/run_all.py:190-192, at full size),
   512^3 bf16 for 3200 steps, 1024^3 f32 (4 GiB per field) for 160 steps;
   each also run for fewer steps (64 at 512^3, 32 at 1024^3) and that
   run's global sum held equal to the plain version's over the same passes;
   the 512^3 f32 field through ``solve()`` equal to the CLI run's, and
   after 1600 steps (the depth cut from 3200 to keep the script
   near its time) held bit for bit against the plain version's over the
   same steps, and against the ``torch`` backend's on the card (the serial
   oracle's f32 arithmetic: same order, two roundings) at the reference's
   f32 tolerance scaled by steps (5e-6 per 30 steps). The plain version's
   side of these comparisons (the global sums, the 1600-step plain and
   ``torch`` fields) is computed by a child process started at the top of
   the script, beside phase 1's build (the card idle) and the card-only
   tests (plain PyTorch builds and launches no kernel); the script waits
   for it before phase 2, whose byte comparisons would share the card
   with it;
3b. ``calibrate`` on the card, in this process
   (``heat_tpu_torch.calibrate.run``): the memory stream (256 MiB f32, 256
   in-place passes a call), the 2D sweep (4096^2 f32 x 8192, 16 steps a
   pass) and the 3D sweep (512^3 f32 x 1024, 8 a pass), each through the
   two-point protocol; the record trustworthy with every rate fitted, the
   stream at most 1.05 x the data sheet's 3.35 TB/s, the 2D sweep's rate
   within 10% of phase 3's 4096^2 f32 x 8192 rate; the pass lists the
   loaded calibration gives at 512^3 and 1024^3, f32 and bf16, beside
   ``machine.DEFAULT``'s (no timing); and, touching no device, ``plan``
   for configs/hip.dat and its ``mpi_cuda`` variant (rc 0, the config,
   mesh and halo lines) and ``viz`` of a small .dat file (the PNG
   written, or, without matplotlib, a non-zero exit naming it and no
   file);
3c. the headline measurement, ``bench`` through ``cli.main`` at its
   defaults on the card (4096^2 f32 x 8192, the ``hat`` IC, three
   repeats of the two-point protocol): the record's ``platform`` is
   ``cuda``, its ``kernel`` ``cuda ftcs2d``, one call's launches the
   pass schedule's at 16 steps x 512 calls of ``advance``'s fused pass
   (512), the counts of the run those of the warm-up and the ten timed
   calls, ``vs_baseline`` the rate over the card's one-pass bound (the
   data sheet's 3.35 TB/s over 8 B a point); then the supervised entry,
   ``python -m heat_tpu_torch.bench`` as a child from the repository root
   (``HEAT_BENCH_TOTAL_BUDGET_S=300``, its cache in the scratch
   directory): rc 0, a last line without ``error`` carrying the metric,
   the cache written with that metric and value;
4. configs/serial.dat (1024^2, 30 steps) on ``cuda`` in f32, and a 64^3 f32
   solve at sigma 0.15 under edges and ghost BC for 50 steps, each written
   to soln.dat and read back, against the serial numpy oracle at the
   reference's f32 cross-backend tolerance (atol 5e-6,
   tests/test_backends.py);
4b. the on-card certification, ``heat_tpu_torch.labs.chip_check.main``
   (the port of ``benchmarks/chip_check.py``; its record in the scratch
   directory): the reference's 23 cases through the backends' own entry
   points — 2D n=200 x 24 steps (no multiple of the streamed tile) on
   ``torch`` and ``cuda`` under edges/ghost/periodic in f32 and bf16,
   fuse 0 and 1 on ``cuda``; 3D 48^3 x 10 at sigma 0.15 on ``cuda``, f32
   and bf16; ``sharded`` 256^2 x 20 f32 on a 1x1 mesh under each BC —
   each against the serial oracle in f32 (5e-6 f32, 5e-2 bf16): all 23
   rows ok, ``ftcs2d`` and ``ftcs3d`` launched (counts and seconds
   printed);
5. the serve main path, ``heat_tpu_torch.cli.main(["serve", "--requests",
   F, "--out-dir", D, "--json", "--lanes", "8", "--chunk", "16",
   "--buckets", "256,512,1024"])`` with the lane launch counts zeroed just
   before and read just after; F holds 56 requests from
   ``numpy.random.default_rng(0)``: 40 2D f32 (sides 128-1024, ntime
   1000-8000 and not a multiple of 16), 8 bf16 twins of f32 requests, 8 3D
   f32 (sides 64-256, ntime 100-800); sigma per request, edges and ghost BC
   in turn, four initial conditions. Every record ok; the lane launches
   equal the passes of the dispatched chunks, and a chunk is at most
   ``len(cuda_lanes.passes(nd, 16))`` launches of its kernel (printed per
   kernel); no lane-kernel fallback;
   served a second time under ``torch.profiler``, every record ok and the
   npz files byte-equal to the first run's (the card's busy time by kernel,
   and the device seconds and launches of ``lanes2d``, ``lanes3d`` and
   ``lanes_init`` by name, are a measurement: "not measured" where the
   profiler fails or sees no device time); served a third time with
   ``--serve-lane-kernel torch`` (the plain versions, on the card), every
   record ok, no lane kernel launched, byte-equal npz files: that run
   (about 90 s on an H100) takes a child process of its own, started
   before phase 1 and waited for before phase 2 times anything, so it
   runs beside the build, the card-only tests and phase 2's byte
   comparisons, which time nothing (``start_plain_serve``); six small f32
   requests against the serial oracle (5e-6 per 30 steps); every field in
   the maximum principle's [1, 2] envelope. Prints the served cell-steps
   per second, the chunks, the tail chunks, the boundary wait and the
   launches by bucket, and each bf16 twin's mean gap from its f32 request
   beside the gaps that a wrong sigma or initial condition makes in f32
   (a measurement: bf16 lanes round every step and stagnate, see
   phase_serve); the numerics observatory is on in every serve run (the
   default);
5b. serving semantics at phase 5's arguments, through the same CLI entry
   point (each run's launch counts and fault plans reset just before it):
   a steady population from ``default_rng(1)`` — 24 ``until=steady``
   requests (20 2D, sides 128-1024, f32 and bf16; 4 3D, sides 64-256;
   sine and hat ICs, edges and ghost BCs), each ``tol`` picked so that
   the closed-form admission prediction lands between 25% and 75% of
   ntime, and 4 fixed-step twins — served with ``--serve-lane-kernel
   cuda`` and again with ``torch`` (the plain versions, on the card):
   every status, ``exit``, ``steps_done``, ``predicted_steps``,
   ``steady_state`` record, ``numerics_violation`` record and npz byte
   equal; every stats row the observatory read equal (resid, tmin, tmax,
   the countdown) but heat (a sum), held within 1e-5 relative; launches
   equal to the dispatched chunks' passes; per request the predicted
   against the actual retirement step, ``steps_saved``, the wall, the
   served cell-steps/s on the steps done, and (once more under
   ``torch.profiler``, npz byte-equal) the card's busy share; then a
   fault population from ``default_rng(2)`` (four 2D, two 3D f32
   requests) on the kernels: ``--serve-on-nan rollback`` with
   ``lane-nan`` in one 2D and one 3D request at dispatch depths 2 and
   off: 2 rollbacks, every npz byte-equal to the clean run, launches
   equal to the chunks' passes (rollback adds no kernel and no copy); a
   sigma-9 request quarantined after 2 rollbacks, its lane-mate
   byte-equal; ``perturb`` under ``--numerics-guard quarantine``: the
   request fails with the numerics message, the others byte-equal;
   ``Engine.start()`` with one request, then a burst of 7: at least one
   lane-tier growth, every field byte-equal to the offline ``run()``;
   ``--fetch-watchdog 2 --inject fetch-hang@3:ms=10000``: the watchdog
   fails the hung group, serve exits 1 well inside the hang;
5c. the serving front, through ``python -m heat_tpu_torch serve`` at phase
   5's arguments: (1) ``--listen 127.0.0.1:0 --cache on
   --engine-ckpt-interval 64 --probe-interval 1`` in a process of its own
   (started together with (3)'s server, both listening before anything
   is timed), phase 5's file POSTed to ``/v1/solve`` as one NDJSON
   stream: every streamed record equal to phase 5's offline record but for the keys
   that follow the wall clock or the arrival order (queue_wait_s, solve_s,
   steps_per_s, trace_id, path, lane, usage.chunks, usage.lane_s), every
   npz byte-equal to phase 5's, the default tenant's usage steps, chunks
   and bytes on ``/v1/usage`` and ``/metrics`` equal to the records' sums,
   ``/tracez`` a Chrome trace, ``/statusz`` answering, the memory
   watermark's source ``device`` and non-zero; (2) the same file again
   under new ids: every request a full cache hit, npz sha256 equal, no
   chunk dispatched (so no lane launch), every probe ok, no 5xx; (3) a
   fresh server with the cache off and ``--engine-ckpt-interval 64``,
   ``POST /drainz?handoff=1`` once its first generation is published,
   then ``serve --resume`` in a new process: every npz byte-equal to
   phase 5's, every resumed record marked ``resumed``; beside that
   child, in this process: the ``ckpt-manifest-corrupt`` fault on a
   copy's handoff manifest: the resume falls back one generation,
   byte-equal; ``cache-corrupt`` and ``cache-stale`` on a cache holding
   one request's entry: quarantined, recomputed byte-equal; (4) phase
   5's file with the observatories at the reference's defaults (``--prof on``, the ring on) and with
   ``--prof off --trace-buffer 0``, two pairs in turns: walls, boundary
   counts, npz byte-equal; (5) one run with ``--trace``: the ``trace``
   subcommand's summary and the split of a chunk's host time (boundary
   fetch, the scheduler's own work, device-idle gaps, writer jobs) from
   the trace; (6) ``run --trace`` at 4096^2 f32 for 320 steps in 16-step
   chunks: one chunk span per launch of ``ftcs2d`` (and the warm-up's in
   the compile span);
5d. mega-lanes (a request over every bucket served over every shard of
   the mesh through the sharded padded carry): (1) ``serve --mega-lanes
   1`` on phase 5's 56 requests plus 4096^2 f32 x 8192 and 4096^2 bf16 x
   256 (edges, hat): every record ok, the two oversized ones placed
   ``mega`` with no bucket, ``placement`` {mega 2, packed 56}, a mega
   machinery build, the 56 packed npz byte-equal to phase 5's, ``ftcs2d``
   launches equal to the mega chunks' passes (each chunk: divmod(k - 1,
   kf) blocks of kf, the remainder, the final step; the reference's
   passes at the padded shard shape); the f32 npz byte-equal to ``run
   --backend cuda`` and ``--backend sharded`` of its config, the bf16 npz
   to the same mega machinery on the plain bounded version on the card;
   (2) the same oversized request without ``--mega-lanes``: rejected (auto
   is 0 on one card) with the reference's reason and ``hint: "enable
   --mega-lanes"``; (3) each mega request alone in this process, 4096^2
   f32 x 8192 and config 4 (512^3 f32 x 3200 at sigma 1/6, ``--buckets
   256``): field byte-equal to ``run --backend cuda``, launches equal to
   the pass schedule's, served cell-steps/s beside phase 3's points/s,
   chunks, launches a chunk, the host's ms a chunk from a ``--trace`` run
   and the card's busy share from a ``torch.profiler`` run; (4) hip.dat
   (32768^2 f32 x 128, ghost) on 2x2 shards of the one card through the
   ``mega_device_count`` seam set to 4, in this process with the field in
   memory: its sha256 equal to phase 7's first 2x2 sharded field; (5) on
   4096^2 f32 x 512: ``lane-nan`` healed under ``--serve-on-nan
   rollback``, and ``begin_drain(handoff=True)`` with the mega occupant
   held in flight then ``serve --resume`` in a new process, both
   byte-equal to the ``run`` field and the resumed record marked; (6) one
   chunk of the 4096^2 and 512^3 mega shapes in f32 and bf16 on the
   kernels against the plain bounded version (boundary vector and field
   bytes), and the f32 chunk's deepest pass and its final 1-step pass
   timed beside the plain pass and the bound;
5e. the fleet on the card: five port backends, ``python -m heat_tpu_torch
   serve --listen 127.0.0.1:0`` processes at phase 5's arguments with
   ``--json --engine-ckpt-interval 1024`` (b1 also ``--mega-lanes 1``;
   b2 and b4, the drills' victims, every 256, so that each publishes a
   checkpoint well inside its wave), started together and warmed with one
   request of each bucket, dtype and rank sent directly; phase 5's 56
   requests (under new ids) through the fleet router in this process
   (``heat_tpu_torch.labs.fleet_lab.run_wave``) over 1, 2 and 4 backends
   (b0..b3) and through ``python -m heat_tpu_torch fleet --backends b0,b1
   --json`` (the CLI router, a process of its own, drained by ``POST
   /drainz``: its ``fleet_summary`` line) over 2: every record ok, every
   npz byte-equal to phase 5's (``check_sample`` too); the wall, the
   served cell-steps/s and the placements per backend of each, beside
   phase 5's direct serve; phase 5d's 4096^2 f32 x 8192 through a router
   over b0 and b1: placed ``mega`` on b1 only, npz byte-equal to phase
   5d's; the steal drill (``steal_drill``: b2 loaded, b3 joins through the
   backends file, a forced ``Router.steal`` once b2 has published a
   checkpoint with work pending) and the kill drill (``kill_drill``: b4,
   fresh, SIGKILLed beside b1 once it has published a checkpoint of the
   wave, so the survivor resumes a manifest of this wave), both on every
   second request of phase 5's file: every request ok, none lost, none
   twice, npz byte-equal, a flight dump; each surviving backend's summary
   (lane passes, no lane-kernel fallback, b1's mega placement) and no
   kernel library built during the phase; then the resilience lab
   (``fleet_resilience_lab``: flap, stream-cut, hedge and deadline drills
   over in-process engines and gateways on the card, f32, 12 requests):
   no row lost or duplicated, bytes equal to a direct engine solve, the
   p99 ratio and the hedge's win printed as measurements;
5f. the invariant guard (``phase_invariants``): ``python -m
   heat_tpu_torch check`` and ``check --strict-allows`` (the AST rule
   families and the CUDA-source rules; children started at the top of the
   script, CPU only), each exit 0; ``python -m heat_tpu_torch audit
   --json`` on the card (started right after the card-only cases), exit
   0 under ``set_sync_debug_mode("error")``, every family with its
   kernels and their launches printed, ``ftcs2d``, ``ftcs3d``,
   ``lanes2d`` and ``lanes3d`` among them; phase 5's 56 requests served
   again by ``serve`` in a child process with ``HEAT_TPU_LOCKCHECK=1
   HEAT_TPU_RACECHECK=record``: rc 0, every record ok, every npz
   byte-equal to phase 5's, lane kernels launched and no
   ``lane_kernel_fallback``, zero lock-order violations and zero races
   (the summary's ``invariant_guard``), its wall printed beside phase 5's
   unarmed wall; and ``labs/fleet_resilience_lab.py --requests 12 --dtype
   float32 --gates bytes`` armed the same way in a child process (the
   fleet, gateway, engine, writer and observatory ranks; not the solve
   cache's, which the card-only case
   ``test_armed_engine_on_the_card_has_no_violation`` takes), started
   last and waited for after phase 6's byte comparisons, which it
   overlaps (``finish_invariants``; its timing gates are printed, not
   checked): rc 0, its byte gates held, zero violations and zero races;
5g. perfcheck on the card (``phase_perfcheck``), two children waited
   for before phase 6 times anything: ``python -m
   heat_tpu_torch.labs.serve_lane_kernel_lab --requests 16`` on the card
   (``start_lane_lab``, started with the armed resilience lab beside
   phase 6's byte comparisons; ``lanes2d`` against the plain lane body,
   ``ftcs2d`` solo solves): ``bit_identical``, ``solo_sample_identical``
   and ``zero_fallbacks`` true, both kernels launched; and ``python -m
   heat_tpu_torch perfcheck --no-fresh`` over the committed lab records
   (``heat_tpu_torch/labs/artifacts``; ``start_perfcheck``, no device,
   started at the top of the script), every line printed: a ``FAIL`` of
   a correctness check (an identity, zero-count, reconciliation,
   quarantine, recovery, export or compile gate, a missing record) fails
   the run; the speed and band checks named in ``PERFCHECK_SPEED`` are
   printed under a heading of their own with their numbers;
6. the kernel lab's candidates L1-L5 (``lab2d``, ``lab3d``): every
   (kernel, variant, dtype) against its plain version on the card, bytes,
   at the JAX lab's check shapes, depths 1 and the deepest its TPU geometry
   takes, on every compiled Hopper tile, and with bounds narrower than the
   field and with a NaN planted in an interior cell (the same NaN cells,
   the same bytes elsewhere) on the streamed tile and the first band tile;
   each compiled 2D tile's rows, columns and shared memory at every depth
   (``heat_lab2d_geometry``: the streamed instances' static shared memory
   as compiled) equal to ``cuda_lab``'s ``STREAM_2D`` and ``smem_bytes``,
   and compiled at the depths ``check_launch`` takes; the K1-form instances against ``ftcs2d``
   (k 16 and 32) and L1 against ``ftcs3d`` on the same inputs, each at the
   shipped streamed tile (the same template instances,
   ``stencil2d_stream.cuh`` / ``stencil3d_stream.cuh``) and at a tile of
   the earlier band design (64x96, ``stencil2d.cuh``; 16x16x32,
   ``stencil3d.cuh``); then the lab's main path,
   ``heat_tpu_torch.labs.kernel_lab.main`` (what ``python -m
   heat_tpu_torch.labs.kernel_lab`` calls) with the lab launch counts
   zeroed just before and read just after: every ``check*`` experiment,
   then one bench per kernel and variant at full size (L1/L2 512^3 f32
   k=8 at the shipped streamed tile, and L1 at the band tile 16x16x32
   beside it, L3 16384^2 bf16 k=16, L4/L5 32768^2 bf16 k=16 at the
   shipped streamed tile 256x128, and L4 at the band tile 64x96 beside
   it), each row's plain
   version timed once at its shape and held to the kernel's bytes. Prints
   each row's ms per pass, its bound, the plain version's ms and the
   shipped kernel's ms at the same shape, dtype and depth.

7. the sharded backend (``--backend sharded``), its main path through
   ``heat_tpu_torch.cli.main(["run", "--backend", "sharded", ...])`` with
   the launch counts zeroed just before and read just after:
   ``configs/hip.dat`` (32768^2, sigma 0.25, the ``hip`` preset in f32
   since f64 has no kernel, ntime cut to 128, no heartbeat) on 2x2 shards
   in this process (``--virtual-devices 4 --mesh 2x2``), ``--comm staged``
   then ``direct``, and 512^3 f32 at sigma 1/6 on 2x2x1 shards for 64
   steps under edges and ghost BC: each field against the single-device
   ``cuda`` run of the same config, bytes, and ``ftcs2d``/``ftcs3d``
   launches equal to shards x passes (the reference's passes at the
   padded shard shape, kf from ``fuse_depth_sharded``); at 8192^2 on 2x2
   shards, seq = indep, staged = direct and the parity order (IC start) =
   the default order (both on the torch step), bytes; bf16 at 8192^2 and
   256^3 through the kernels against the same sharded path on the plain
   bounded version on the card, bytes; ``ftcs_multistep_bounded_cuda``
   with the bounds of a corner, an edge and an inner shard (2D 3x3 shards
   of 6144^2, 3D 3x3x3 of 384^3), f32/bf16, edges/ghost, at kf and kf - 3,
   owned cells against the plain version, bytes; the multi-process
   worlds at 2048^2 (``launch -n 2 -- run ... --comm staged --mesh 2x1``
   over gloo, the two ranks sharing the card, and ``launch -n 1 ...
   --comm direct``, a 1-rank NCCL world): their ``soln.dat`` and
   ``soln#####.dat`` files and gsum equal to ``--virtual-devices 2`` in
   this process; ``launch -n 2 ... --comm direct`` refuses, naming
   ``--comm staged``. These five worlds (with the restarted world and its
   clean twin below) are child processes started together right after
   the build, each in a directory of its own, beside the card-only tests
   and phase 2's byte comparisons, and waited for before phase 2 times
   anything (``start_worlds``, ``finish_worlds``); phase 7 checks them, so
   their points/s come from a card they shared. Every hip.dat and 512^3
   run also with ``--exchange overlap`` (the interior on the kernel while the halo flies, then the
   rim regions), its field equal to indep's and the single run's, its
   launches those of the interior and every region in their own passes;
   bf16 overlap at 8192^2 and 256^3 equal to the plain bounded version;
   the kernel against its plain version on the interior and every region
   of every overlap run's shards (shifted bounds, kept cells, bytes); a
   checkpointed 2-rank staged world at 2048^2 under ``launch
   --max-restarts 2`` crashed at step 20 by rank 1 (``--inject
   crash@20:proc=1``): one ``launch_restart`` record resuming at step 16,
   soln files and gsum equal to the uninterrupted world. Prints points/s
   of every sharded run beside the single-device run, overlap against
   indep, the kernel calls and launches per shard and exchange block, one
   exchange's ms (CUDA events around the exchange alone) and the bytes
   the shards receive, direct and staged, at the main path's shard shapes;
   from ``torch.profiler``, one overlap block at hip.dat's and 512^3's
   shard shapes, staged and direct: the side-stream copies' µs overlapped
   with the interior kernels and the card's busy share of the block; and
   each kernel's ms per pass at a corner shard's shape and at an overlap
   face region's beside its plain version and bound.

``python3 chip_smoke.py --labs`` builds the kernels and runs, one after
another in this process, the ports of the measuring labs of
``benchmarks/`` at their card sizes (``LAB_RUNS``), each record written to
``heat_tpu_torch/labs/artifacts/``: ``chip_check``; ``ckpt_overlap
--backend cuda --n 4096`` (256 steps, a checkpoint every 32);
``overlap_ab`` (16384^2 x 512 on 1x1, fuse 16 and 32);
``collective_overhead`` (post and add chains, the fit over fuse 1, 8, 16
and 32 beside an exchange alone); ``weak_scaling --local-n 16384`` and
``--virtual 4`` (200 steps); ``sharded3d_check`` (512^3 x 960, auto, 8
and 32); ``run_all`` (the five BASELINE.json configurations at full size,
each row in its own child); then the supervised headline entry, ``python
-m heat_tpu_torch.bench``, its cache ``labs/artifacts/last_bench.json``.
Each lab's identity gates (``lab_gates``: bytes, fuse depths,
kernels launched) fail the run; its headline is printed, its speed gates
with it, not checked. The last lines are the ``nvidia-smi`` line and
``{"ok": true, ...}``.

``python3 chip_smoke.py --worlds`` on a host with several cards builds the
kernels and runs only ``phase_worlds``: worlds of one rank per card,
direct (NCCL) and staged, against the same shards in one process; on four
cards hip.dat's 32768^2 on 2x2 ranks over NCCL with ``--exchange
overlap`` beside indep (sums equal, points/s of each); and a checkpointed
world of one rank per card crashed and restarted by ``launch
--max-restarts 2`` (files and sums equal to the uninterrupted world).

The default run prints the seconds of each phase before its last three
lines: the ``nvidia-smi`` line, a JSON object with one entry per kernel
and main-path shape, and the very last line, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"          # scratch for input.dat / soln.dat (gitignored)
SOURCES = {name: f"heat_tpu_torch/ops/csrc/{name}.cu"
           for name in ("ftcs2d", "ftcs3d", "lanes2d", "lanes3d", "lab2d",
                        "lab3d")}
K1 = "heat_tpu/ops/pallas_stencil.py:256"   # _pallas_2d
K2 = "heat_tpu/ops/pallas_stencil.py:633"   # _pallas_2d_coltiled
K3 = "heat_tpu/ops/pallas_stencil.py:489"   # _pallas_3d_aligned
K4 = "heat_tpu/ops/pallas_stencil.py:1115"  # _lane_pallas_2d
K5 = "heat_tpu/ops/pallas_stencil.py:1279"  # _lane_pallas_3d
# the kernel lab's Pallas kernels L1-L5, by the port's function name
LAB = "benchmarks/kernel_lab.py"
L_REPLACES = {"lab_3d_tiled": f"{LAB}:171",            # pallas_3d_tiled
              "lab_3d_rolled": f"{LAB}:279",           # pallas_3d_rolled
              "lab_thin2d_variant": f"{LAB}:474",      # pallas_thin2d_variant
              "lab_2d_coltiled": f"{LAB}:628",         # pallas_2d_coltiled
              "lab_2d_coltiled_rolled": f"{LAB}:744"}  # ..._coltiled_rolled
# phase 6: the lab's experiments, driven through its entry point: every
# check, then one bench per kernel and variant at full size (tune_on_chip's
# lab3d / thin / lab2d shapes), at the shipped kernels' tile and depth
LAB_BENCHES = (
    ["bench3d", "256,32,32,8", "16,16,32,8"],
    ["bench3d_rolled_var", "f32", "256,32,32,8"],
    ["bench3d_rolled_var", "fma", "256,32,32,8"],
    ["benchthin", "16384", "bfloat16", "shrink,256,128,16",
     "rolled,256,128,16", "rolledfma,256,128,16", "bf16native,256,128,16"],
    ["bench2d", "256,128,16", "64,96,16"],
    *(["bench2d_rolled_var", v, "256,128,16"]
      for v in ("f32", "fma", "bf16native", "bf16fma")),
)
# the reference's CostEstimate counts of operations per lane cell-step
# (pallas_stencil.py:1156 and :1310), for a second bound beside the kernels'
# own count (machine.py: 7 / 9 f32 operations per live cell-step)
LANE_COST_ESTIMATE_OPS = {2: 11, 3: 13}
LANE_R = {2: (0.25, 0.2, 0.1), 3: (1 / 6, 0.15, 0.1)}
# phase 5g: the perfcheck checks whose FAIL is a speed or band reading, not
# a correctness one ("<record>: <field>" for a record's gate, else the
# check's name); each FAIL among them is printed with its number
PERFCHECK_SPEED = frozenset((
    "baseline overhead gate",
    "serve_lab.json: aggregate_speedup",
    "trace_overhead_lab.json: full_within_2pct_of_off",
    "serve_chaos_lab.json: healthy_within_10pct",
    "serve_frontend_lab.json: edf_vs_fifo_hit_rate_delta",
    "serve_mega_lab.json: packed_within_10pct",
    "serve_mega_lab.json: packed_within_10pct_of_serve_lab",
    "numerics_overhead_lab.json: on_within_2pct_of_off",
    "serve_steady_lab.json: throughput_multiplier",
    "serve_cache_lab.json: warm_speedup",
    "fleet_lab.json: speedup_2_backends",
    "fleet_lab.json: monotone_at_4",
    "fleet_resilience_lab.json: flap_availability",
    "fleet_resilience_lab.json: flap_p99_ratio",
    "fleet_resilience_lab.json: hedges_won",
    "fleet_resilience_lab.json: breaker_steals_suppressed",
    "lane-kernel cost band",
    "lane-kernel card gate",
    "calibration cross-check",
    "static-prior band",
))
# phase 5: the serve main path's engine knobs
SERVE_ARGS = ("--lanes", "8", "--chunk", "16", "--buckets", "256,512,1024")
# phase 5's profile: each serve kernel's device time, by a pattern of its
# name (the streamed kernels, or an earlier commit's band / one-step ones)
SERVE_KERNELS = {"lanes2d": r"lanes2d_(stream_)?kernel\b",
                 "lanes3d": r"lanes3d_(stream_)?kernel\b",
                 "lanes_init": r"lanes_init\b"}
F32_ATOL = 5e-6                 # tests/test_backends.py:33
SIGMA_3D = 1 / 6                # benchmarks/run_all.py:192
# phase 3's runs: bench.py's shape (the python/cuda benchmark) and
# configs/hip.dat's, (n, sigma, nu, dom_len, ntime, dtype); the reference's
# config 4 at full size in f32 and bf16 and 1024^3 f32 with ntime cut to
# 160, each with the steps of a shorter run held against the plain version
MAIN_2D = {"4096 f32": (4096, 0.25, 0.05, 2.0, 8192, "float32"),
           "32768 f32": (32768, 0.25, 0.05, 1.0, 128, "float32"),
           "32768 bf16": (32768, 0.25, 0.05, 1.0, 128, "bfloat16")}
MAIN_3D = {"512^3 f32": (512, SIGMA_3D, 0.05, 2.0, 3200, "float32", 64),
           "512^3 bf16": (512, SIGMA_3D, 0.05, 2.0, 3200, "bfloat16", 64),
           "1024^3 f32": (1024, SIGMA_3D, 0.05, 2.0, 160, "float32", 32)}
# the depth of phase 3's 512^3 f32 bit-for-bit and oracle checks (half the
# config-4 run)
CHECK_3D_STEPS = 1600
ENVELOPE_TOL = 1e-5             # phase 5: rounding past the [1, 2] envelope
ICS = ("hat", "hat_small", "hat_half", "uniform")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def field(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (1.0 + torch.rand(shape, generator=g, device="cuda")).to(dtype)


def event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events,
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int):
    """Mean device time of ``fn()``'s kernels per call over ``reps`` calls,
    from ``torch.profiler`` (the kernels' own time, without the host's
    time between launches, which bounds back-to-back calls of a chunk
    that takes less time on the card than its launches take on the host);
    None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def dt_name(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("float32", "f32").replace(
        "bfloat16", "bf16")


def full_bounds(shape) -> tuple:
    return tuple(v for s in shape for v in (0, s - 1))


def nan_bounds(shape) -> tuple:
    """A frozen ring 41 cells wide: cells 0..40 and size-41..size-1 of each
    axis frozen."""
    return tuple(v for s in shape for v in (40, s - 41))


def inner_bounds(shape) -> tuple:
    """Bounds inside the field on every axis: cells 0..3 and size-5..size-1
    frozen, so blocks near the edges see frozen planes in their halo while
    no updating cell reads across the array's edge."""
    return tuple(v for s in shape for v in (3, s - 5))


# --------------------------------------------------------------------------


def phase_build():
    import torch

    from heat_tpu_torch.ops import _build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    each = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    print(f"[phase 1] {', '.join(_build.KERNELS)} built for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s (one nvcc each, in parallel: "
          f"{', '.join(f'{n} {t:.1f} s' for n, t in each.items())})")
    # the .dat writer's library, built before phase 7's worlds start: the
    # held-against files are then all written by the one native writer
    from heat_tpu_torch.io import native

    t0 = time.perf_counter()
    check(native.native_available(), "the native .dat writer (io/native, "
                                     "make and g++) did not build or load")
    print(f"  native .dat writer {native._SO.name} ready in "
          f"{time.perf_counter() - t0:.3f} s")
    for name in _build.KERNELS:
        funcs = _build.ptxas_report(_build.build_log(name))
        regs = [f[1] for f in funcs]
        spills = sum(f[2] + f[3] for f in funcs)
        print(f"  ptxas {name}: {len(funcs)} kernel instances, {min(regs)}-"
              f"{max(regs)} registers, {spills} bytes of spill traffic")
        for fn, nreg, st, ld in funcs:
            m = re.search(r"stream_kernelI(f|13__nv_bfloat16)Li0ELi0ELi(\d)E",
                          fn)
            if name == "ftcs3d" and m:
                print(f"    ftcs3d {'f32' if m[1] == 'f' else 'bf16'} "
                      f"k={m[2]}: {nreg} registers, spill stores {st} B, "
                      f"loads {ld} B")
            # stencil2d_stream.cuh's <T, ORDER, UPD, EVERY, K>
            m = re.search(r"stream_kernelI(f|13__nv_bfloat16)Li0ELi0ELb0E"
                          r"Li(\d+)EE", fn)
            if name == "ftcs2d" and m:
                print(f"    ftcs2d {'f32' if m[1] == 'f' else 'bf16'} "
                      f"k={m[2]}: {nreg} registers, spill stores {st} B, "
                      f"loads {ld} B")
            # lanes2d.cu's streamed <T, K> and the band design's <T>;
            # lanes3d.cu's streamed <T, K> and the one-step design's <T>
            m = re.search(r"(lanes[23]d)_(stream_|band_|)kernelI"
                          r"(f|13__nv_bfloat16)(?:Li(\d+)E)?E", fn)
            if name in ("lanes2d", "lanes3d") and m and m[1] == name:
                design = {"stream_": "stream", "band_": "band",
                          "": "step"}[m[2]]
                print(f"    {name} {design} "
                      f"{'f32' if m[3] == 'f' else 'bf16'}"
                      f"{f' k={m[4]}' if m[4] else ''}: {nreg} registers, "
                      f"spill stores {st} B, loads {ld} B")


def phase_compare():
    """Kernel vs plain version, bytes. Returns max |err| per (kernel,
    shape)."""
    import torch

    from heat_tpu_torch.ops import cuda_stencil as cs

    def wrapper(bc, T, r, k, plain):
        if bc == "edges":
            return cs.ftcs_multistep_edges_cuda(T, r, k, plain=plain)
        if bc == "ghost":
            return cs.ftcs_multistep_ghost_cuda(T, r, 1.0, k, plain=plain)
        if bc == "periodic":
            return cs.ftcs_multistep_periodic_cuda(T, r, k, plain=plain)
        if bc == "inner":
            return cs.ftcs_multistep_bounded_cuda(T, r, k, inner_bounds(
                T.shape), plain=plain)
        if bc == "nan":
            return cs.ftcs_multistep_bounded_cuda(T, r, k, nan_bounds(
                T.shape), plain=plain)
        # "pass": one kernel pass of exactly k steps, default bounds
        return cs._pass(T, r, k, full_bounds(T.shape), plain=plain)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, bc, dt, k, r)
             for shape in ((67, 130), (1000, 4099), (4096, 4096))
             for bc in ("edges", "ghost", "periodic")
             for dt in (f32, bf16) for k in (1, 7, 16) for r in (0.25, 0.2)]
    cases += [((32768, 32768), "edges", dt, 16, 0.2) for dt in (f32, bf16)]
    cases += [(shape, "pass", dt, k, 0.2) for shape in ((67, 130), (4096, 4096))
              for dt in (f32, bf16) for k in (17, 32)]
    # the streamed ftcs2d's segment and region ends: rows not a multiple of
    # its segment (16 rows at these sizes), fewer rows than a segment and
    # its 2k halo, widths not a multiple of 4 or of an output strip
    cases += [(shape, bc, dt, k, 0.2)
              for shape in ((300, 4099), (20, 70))
              for bc in ("edges", "ghost", "periodic")
              for dt in (f32, bf16) for k in (1, 7, 16)]
    # bounds inside the field (lo 3, hi size-5) through the bounded wrapper,
    # at both streamed shapes (k <= 16 and 17..32); and NaNs planted in an
    # interior cell and 4 rows from a frozen ring 41 cells wide (which the
    # NaN must reach, and spread into, but not cross in 32 steps: across
    # the array's edge the plain version's rolls wrap where the kernel
    # reads zeros, and a frozen cell keeps c + 0*lap, NaN for a NaN lap)
    cases += [(shape, "inner", dt, k, 0.2)
              for shape in ((67, 130), (4096, 4096))
              for dt in (f32, bf16) for k in (1, 16, 32)]
    cases += [((1000, 4099), "nan", dt, k, 0.2)
              for dt in (f32, bf16) for k in (7, 16, 32)]
    cases += [(shape, bc, dt, k, r)
              for shape in ((24, 20, 130), (67, 45, 129), (256, 256, 256))
              for bc in ("edges", "ghost", "periodic")
              for dt in (f32, bf16) for k in (1, 4, 8) for r in (1 / 6, 0.15)]
    # the streamed ftcs3d's segment ends: rows not a multiple of its
    # segment (sized per field to fill whole waves), and fewer rows than a
    # segment and its 2k halo
    cases += [(shape, bc, dt, k, 0.15)
              for shape in ((300, 40, 70), (20, 33, 40))
              for bc in ("edges", "ghost", "periodic")
              for dt in (f32, bf16) for k in (1, 4, 8)]
    cases += [(shape, "inner", dt, k, r)
              for shape in ((67, 45, 129), (256, 256, 256))
              for dt in (f32, bf16) for k in (1, 5, 8) for r in (1 / 6, 0.15)]
    # tests/test_torch_cuda_stencil3d.py's card-only case: its CPU-seeded
    # field ("cpu-seeded"), edges, r = 1/6
    cases += [((67, 45, 129), "cpu-seeded", dt, k, 1 / 6)
              for dt in (f32, bf16) for k in (1, 4, 8)]
    cases += [((512,) * 3, "pass", f32, 8, SIGMA_3D),
              ((512,) * 3, "pass", bf16, 4, SIGMA_3D),
              ((1024,) * 3, "pass", f32, 5, SIGMA_3D)]
    errs = {}
    t0 = time.perf_counter()
    for i, (shape, bc, dt, k, r) in enumerate(cases):
        if bc == "cpu-seeded":
            T = torch.rand(shape, generator=torch.Generator().manual_seed(0))
            T, bc = (1 + T).to(dt).cuda(), "edges"
        else:
            T = field(shape, dt, seed=i)
        if bc == "nan":
            T[44, shape[1] // 2] = T[shape[0] // 2, shape[1] // 3] = float("nan")
        got = wrapper(bc, T, r, k, plain=False)
        want = wrapper(bc, T, r, k, plain=True)
        torch.cuda.synchronize()
        if bc == "nan":
            check(bool(torch.isnan(want[40, shape[1] // 2])),
                  "the NaN did not reach the frozen ring")
            ndiff = 0 if nan_bits_equal(got, want) else int(
                (bits(got) != bits(want)).sum())
            fin = torch.isfinite(want.float())
            err = float((got.float()[fin] - want.float()[fin]).abs().max())
        else:
            ndiff = int((bits(got) != bits(want)).sum())
            err = float((got.float() - want.float()).abs().max())
        key = (cs._KERNELS[len(shape)], shape)
        errs[key] = max(errs.get(key, 0.0), err)
        if (shape[0] >= 4096 and bc != "inner" or bc == "nan"
                or len(shape) == 3 and shape[0] >= 256 and bc != "inner"
                or ndiff):
            print(f"  {key[0]} {shape} {bc} {dt_name(dt)} k={k} r={r:.6g}: "
                  f"{ndiff} cells differ, max|err| {err:g}")
        check(ndiff == 0, f"kernel != plain at {shape} {bc} {dt} k={k} r={r}")
        del T, got, want
        torch.cuda.empty_cache()
    print(f"[phase 2] {len(cases)} kernel-vs-plain cases, 0 differing bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_times():
    """ms per pass at the main path's shapes and depths: kernel (mean of
    many launches) and plain version; the bound from machine.py; in 2D also
    the band design (the kernel lab's K1-form instance at its 64x96 tile,
    ftcs2d's earlier design) on the same field."""
    import torch

    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_lab as cl
    from heat_tpu_torch.ops import cuda_stencil as cs

    dm = device_model(0)
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    for shape, dt, k, reps, plain_reps in (
            ((4096, 4096), f32, 16, 200, 3), ((4096, 4096), bf16, 16, 200, 3),
            ((32768, 32768), f32, 16, 10, 1), ((32768, 32768), bf16, 16, 10, 1),
            ((4096, 4096), f32, 32, 100, 1), ((4096, 4096), bf16, 32, 100, 1),
            ((512,) * 3, f32, 8, 20, 1), ((512,) * 3, bf16, 4, 20, 1),
            ((512,) * 3, f32, 4, 20, 1), ((1024,) * 3, f32, 5, 10, 1)):
        A = field(shape, dt, seed=1)
        B = torch.empty_like(A)
        bounds = full_bounds(shape)
        r = 0.25 if len(shape) == 2 else SIGMA_3D
        ms = event_ms(lambda: cs._launch(A, r, k, bounds, B), reps)
        plain_ms = event_ms(lambda: cs._PLAIN[len(shape)](A, r, k), plain_reps)
        bound_s, bound_by = dm.pass_bound_s(A.numel(), A.element_size(), k,
                                            ndim=len(shape))
        name = cs._KERNELS[len(shape)]
        times[(name, shape, dt, k)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by)
        band = ""
        if len(shape) == 2:
            band_ms = event_ms(lambda: cl._launch(
                "lab_thin2d_variant", "shrink", A, r, k, bounds, (64, 96), B),
                reps)
            times[(name, shape, dt, k)]["band_ms"] = band_ms
            band = f", band design 64x96 {band_ms:.4f} ms"
        print(f"  {name} {'x'.join(map(str, shape))} {dt_name(dt)} k={k}: "
              f"{ms:.4f} ms/pass (plain {plain_ms:.2f} ms, bound "
              f"{bound_s * 1e3:.4f} ms by {bound_by}, {bound_s * 1e3 / ms:.1%} "
              f"of it{band})")
        del A, B
        torch.cuda.empty_cache()
    # ftcs2d's time per pass over its depths at 4096^2 f32 (both streamed
    # shapes), and ftcs3d's at every depth at 512^3 f32 (the data for the
    # schedule's depth; no plain version)
    A = field((4096, 4096), f32, seed=1)
    B = torch.empty_like(A)
    for k in (1, 2, 4, 8, 16, 24, 32):
        ms = event_ms(lambda: cs._launch(A, 0.25, k, full_bounds(A.shape), B),
                      100)
        bound_s, bound_by = dm.pass_bound_s(A.numel(), 4, k, ndim=2)
        print(f"  ftcs2d 4096x4096 f32 k={k}: {ms:.4f} ms/pass, "
              f"{ms / k:.4f} ms/step (bound {bound_s * 1e3:.4f} ms by "
              f"{bound_by}, {bound_s * 1e3 / ms:.1%} of it)")
    A = field((512,) * 3, f32, seed=1)
    B = torch.empty_like(A)
    for k in range(1, cs._KMAX_3D + 1):
        ms = event_ms(lambda: cs._launch(A, SIGMA_3D, k, full_bounds(A.shape),
                                         B), 20)
        bound_s, bound_by = dm.pass_bound_s(A.numel(), 4, k, ndim=3)
        print(f"  ftcs3d 512x512x512 f32 k={k}: {ms:.4f} ms/pass, "
              f"{ms / k:.4f} ms/step (bound {bound_s * 1e3:.4f} ms by "
              f"{bound_by}, {bound_s * 1e3 / ms:.1%} of it)")
    del A, B
    torch.cuda.empty_cache()
    print("[phase 2] times taken")
    return times


def cli_run(input_dat: str, *args, backend: str = "cuda"):
    """One ``run --backend <backend>`` through the CLI entry point in WORK,
    with ``input_dat`` as its input.dat; the launch counts zeroed just
    before and read just after. Returns (stdout, launches)."""
    from heat_tpu_torch import cli
    from heat_tpu_torch.ops import cuda_stencil as cs

    (WORK / "input.dat").write_text(input_dat)
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        cs.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "--backend", backend, *args])
        launches = dict(cs.launches)
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    print("".join(f"    | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"run exited {rc}")
    return out, launches


def expected_launches(shape, dtype: str, ntime: int) -> tuple:
    """(timed, warm-up) launches of one run with no heartbeat: ntime // 16
    multistep calls of 16 steps, each cut into the reference's passes, and
    ntime % 16 one-step launches; the warm-up makes each distinct call
    once."""
    from heat_tpu_torch.ops import pass_schedule

    per_call = len(pass_schedule.passes(shape, dtype, 16))
    n_fused, rem = divmod(ntime, 16)
    return n_fused * per_call + rem, per_call + (1 if rem else 0)


def plain_gsum(n, ndim, sigma, nu, dom_len, ntime, dtype) -> float:
    """Global sum (f64, on the host, as the run reports it) of the plain
    version run in 16-step calls from the run's initial field."""
    import numpy as np
    import torch

    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.backends.common import host_fetch
    from heat_tpu_torch.grid import initial_condition_device
    from heat_tpu_torch.ops.cuda_stencil import ftcs_multistep_edges_cuda

    cfg = HeatConfig(n=n, ndim=ndim, sigma=sigma, nu=nu, dom_len=dom_len,
                     ntime=ntime, dtype=dtype)
    T = initial_condition_device(cfg, "cuda")
    for _ in range(ntime // 16):
        T = ftcs_multistep_edges_cuda(T, cfg.r, 16, plain=True)
    ref = float(np.sum(np.asarray(host_fetch(T), np.float64)))
    del T
    torch.cuda.empty_cache()
    return ref


def check_3d_config():
    """Phase 3's config-4 run (512^3 f32, sigma 1/6, 3200 steps)."""
    from heat_tpu_torch import HeatConfig

    return HeatConfig(n=512, ndim=3, sigma=SIGMA_3D, nu=0.05, dom_len=2.0,
                      ntime=3200, dtype="float32")


def start_plain_refs():
    """Phase 3's plain-version side in a child process, started at the top
    of the script: the plain PyTorch passes and the ``torch`` backend build
    and launch no kernel, so they run beside phase 1's build and the
    card-only tests. ``plain_refs_result`` waits for it."""
    return start_child("plain-refs", "-c",
                       "import chip_smoke as c; c.plain_refs_child()")


def plain_refs_child() -> None:
    """The child of ``start_plain_refs``: the plain version's global sum
    over each phase-3 run's passes (the 3D runs' shorter ones), written to
    ``plain-refs.json``; the config-4 field after CHECK_3D_STEPS steps in
    the plain version's passes and through the ``torch`` backend, written
    to ``plain-512.npy`` and ``torch-512.npy``."""
    import numpy as np

    from heat_tpu_torch import solve
    from heat_tpu_torch.backends.common import host_fetch
    from heat_tpu_torch.grid import initial_condition_device
    from heat_tpu_torch.ops.cuda_stencil import ftcs_multistep_edges_cuda

    jobs = [(key, n, 2, sigma, nu, dom_len, ntime, dtype) for key, (
        n, sigma, nu, dom_len, ntime, dtype) in MAIN_2D.items()]
    jobs += [(f"{key} x{ncmp}", n, 3, sigma, nu, dom_len, ncmp, dtype)
             for key, (n, sigma, nu, dom_len, _, dtype, ncmp)
             in MAIN_3D.items()]
    # the largest fields first: their passes are long kernels that need
    # little of the host, which the build beside them holds
    jobs.sort(key=lambda job: -job[1] ** job[2])
    gsums, seconds = {}, {}
    t0 = time.perf_counter()
    for key, *spec in jobs:
        gsums[key] = plain_gsum(*spec)
        seconds[key] = round(time.perf_counter() - t0, 1)
    cfg = check_3d_config().with_(ntime=CHECK_3D_STEPS)
    T = initial_condition_device(cfg, "cuda")
    for _ in range(cfg.ntime // 16):
        T = ftcs_multistep_edges_cuda(T, cfg.r, 16, plain=True)
    np.save(WORK / "plain-512.npy", host_fetch(T))
    del T
    seconds[f"512^3 f32 x{cfg.ntime}"] = round(time.perf_counter() - t0, 1)
    np.save(WORK / "torch-512.npy",
            solve(cfg.with_(backend="torch"), device="cuda").T)
    seconds[f"torch 512^3 f32 x{cfg.ntime}"] = round(
        time.perf_counter() - t0, 1)
    (WORK / "plain-refs.json").write_text(json.dumps(dict(
        gsums=gsums, seconds=seconds)))


def plain_refs_result(child, timeout: float = 600.0) -> dict:
    """Wait for ``child`` (``start_plain_refs``) and return its global
    sums; a child that fails, or outlasts ``timeout`` (killed then), fails
    the phase."""
    t0 = time.perf_counter()
    wait_child(child, WORK / "plain-refs.log", "the plain-version child",
               timeout)
    out = json.loads((WORK / "plain-refs.json").read_text())
    print(f"[phase 2] the plain-version child (phase 3's comparisons) done, "
          f"waited {time.perf_counter() - t0:.1f} s for it; its seconds from "
          f"its start at the end of each part: {json.dumps(out['seconds'])}")
    return out["gsums"]


def main_path_run(key, n, ndim, sigma, nu, dom_len, ntime, dtype, smi):
    """One timed main-path run; checks kernel, launches and finiteness."""
    import torch

    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    print(f"[phase 3] run --backend cuda --ndim {ndim}, {n}^{ndim} {dtype}, "
          f"{ntime} steps")
    out, launches = cli_run(f"{n} {sigma!r} {nu} {dom_len} {ntime}\n", "--json",
                            "--ndim", str(ndim), "--dtype", dtype,
                            "--report-sum")
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["launches"] == launches, "launch count mismatch")
    timed, warm = expected_launches((n,) * ndim, dtype, ntime)
    check(rec["kernel"] == f"cuda {name}", f"kernel {rec['kernel']}")
    check(launches[name] == timed + warm,
          f"{launches[name]} {name} launches, expected {timed + warm}")
    check(rec["gsum"] is not None and rec["gsum"] == rec["gsum"]
          and abs(rec["gsum"]) < float("inf"), "non-finite field")
    print(f"  {key}: {rec['points_per_s']:.6g} points/s, "
          f"{rec['per_step_s'] * 1e3:.6f} ms/step, {launches[name]} {name} "
          f"launches ({timed} timed + {warm} warm-up) on {smi}")
    torch.cuda.empty_cache()
    return rec


def phase_main_path(smi, plain_gsums):
    """Phase 3: each run held against the plain version's side of it
    (``plain_refs_child``: ``plain_gsums`` and the two 512^3 fields)."""
    import numpy as np
    import torch

    from heat_tpu_torch import solve

    runs = {}
    # each 2D run's field against the plain version run in the same passes
    # from the same initial field: the global sums must be equal
    for key, spec in MAIN_2D.items():
        runs[key] = main_path_run(key, spec[0], 2, *spec[1:], smi)
    for key in MAIN_2D:
        ref = plain_gsums[key]
        got = runs[key]["gsum"]
        print(f"  {key}: gsum {got!r}, plain version {ref!r}")
        check(got == ref, f"{key}: main path's field is not the plain version's")
    # bf16 vs f32 at the same size: the reference's bf16 bound (atol 3e-2
    # per cell, tests/test_backends.py:43) bounds the mean
    diff = abs(runs["32768 bf16"]["gsum"] - runs["32768 f32"]["gsum"]) / 32768**2
    print(f"  32768 bf16 vs f32: mean |dT| bound {diff:.3g}")
    check(diff < 3e-2, "bf16 run drifted from f32")

    for key, (n, sigma, nu, dom_len, ntime, dtype, ncmp) in MAIN_3D.items():
        runs[key] = main_path_run(key, n, 3, sigma, nu, dom_len, ntime, dtype,
                                  smi)
        short = main_path_run(f"{key} x{ncmp}", n, 3, sigma, nu, dom_len, ncmp,
                              dtype, smi)
        ref = plain_gsums[f"{key} x{ncmp}"]
        print(f"  {key} x{ncmp}: gsum {short['gsum']!r}, plain version {ref!r}")
        check(short["gsum"] == ref,
              f"{key}: main path's field is not the plain version's")
    diff = abs(runs["512^3 bf16"]["gsum"] - runs["512^3 f32"]["gsum"]) / 512**3
    print(f"  512^3 bf16 vs f32: mean |dT| bound {diff:.3g}")
    check(diff < 3e-2, "bf16 run drifted from f32")

    # the config-4 run through solve() gives the CLI run's field; its
    # field after CHECK_3D_STEPS steps equals, bit for bit, the plain
    # version's run in the same passes; and against the torch backend (the
    # serial oracle's f32 arithmetic: the same order, two roundings per
    # step, where the kernel rounds the update and s - 6c once) it stays
    # inside the reference's f32 tolerance of 5e-6 per 30 steps, scaled to
    # its steps: the two forms differ by under an ulp per step and an FTCS
    # step at r <= 1/6 does not grow a max-norm difference
    cfg = check_3d_config()
    got = solve(cfg.with_(backend="cuda"), device="cuda")
    check(got.timing.kernel == "cuda ftcs3d", f"kernel {got.timing.kernel}")
    gsum = float(np.sum(np.asarray(got.T, np.float64)))
    check(gsum == runs["512^3 f32"]["gsum"], "solve() and run disagree")
    cfg = cfg.with_(ntime=CHECK_3D_STEPS)
    got = solve(cfg.with_(backend="cuda"), device="cuda")
    T = torch.from_numpy(np.load(WORK / "plain-512.npy")).to("cuda")
    ndiff = int((bits(got.T_dev) != bits(T)).sum())
    print(f"  512^3 f32 x{cfg.ntime} vs the plain version in the same "
          f"passes: {ndiff} cells differ")
    check(ndiff == 0, f"512^3 x{cfg.ntime} field is not the plain version's")
    del T
    oracle = np.load(WORK / "torch-512.npy")
    check(np.isfinite(got.T).all() and got.T.shape == oracle.shape,
          "bad 512^3 field")
    err = float(np.abs(got.T - oracle).max())
    atol = F32_ATOL * cfg.ntime / 30
    runs["512^3 f32"]["oracle_err"] = err
    print(f"  512^3 f32 x{cfg.ntime} vs the torch step (serial oracle "
          f"arithmetic): max|err| {err:g} (atol {atol:g} = 5e-6 per 30 "
          f"steps)")
    check(err <= atol, "512^3 cuda solve off the oracle")
    del got, oracle
    torch.cuda.empty_cache()
    return runs


def phase_calibrate(smi, runs) -> dict:
    """Phase 3b: ``calibrate`` on the card, then ``plan`` and ``viz``
    through the CLI without a device."""
    import contextlib
    import io

    import numpy as np

    from heat_tpu_torch import calibrate, cli, machine
    from heat_tpu_torch.io import write_dat
    from heat_tpu_torch.ops import pass_schedule

    t0 = time.perf_counter()
    path = WORK / "calibration.json"
    print("[phase 3b] calibrate on the card")
    rec = calibrate.run(path)
    cal_s = time.perf_counter() - t0
    check(rec["trustworthy"] and rec["fit_complete"],
          f"calibrate: trustworthy {rec['trustworthy']}, fit_complete "
          f"{rec['fit_complete']} (stream fell back: "
          f"{rec['stream']['floor_fallback']}, 2D overhead-dominated: "
          f"{rec['sweep_2d']['overhead_dominated']}, 3D: "
          f"{rec['sweep_3d']['overhead_dominated']})")
    hbm = rec["stream"]["hbm_bytes_per_s"]
    sheet = machine.PEAKS["H100"].hbm_bytes_per_s
    rate2 = rec["sweep_2d"]["points_per_s"]
    run2 = runs["4096 f32"]["points_per_s"]
    print(f"  stream {hbm:.6g} B/s ({hbm / sheet:.4f} of the data sheet's "
          f"{sheet:.3g}); 2D {rate2:.6g} points/s ({rate2 / run2:.4f} of "
          f"phase 3's {run2:.6g}); 3D {rec['sweep_3d']['points_per_s']:.6g} "
          f"points/s; fitted vpu {rec['chip_model']['vpu_ops_per_s']:.6g}, "
          f"ops3d {rec['chip_model']['ops_rate_3d']:.6g}; vs_table "
          f"{ {k: v for k, v in rec['vs_table'].items() if k != 'basis'} } "
          f"on {smi}; {cal_s:.1f} s")
    check(hbm <= 1.05 * sheet, f"calibrate: stream {hbm:.6g} B/s exceeds "
                               f"1.05 x the data sheet's {sheet:.3g}")
    check(abs(rate2 / run2 - 1) <= 0.10,
          f"calibrate: 2D sweep {rate2:.6g} points/s is not within 10% of "
          f"phase 3's {run2:.6g}")
    fitted = machine.from_calibration(path)
    lists = {}
    try:
        for label, model in (("DEFAULT", machine.DEFAULT),
                             ("calibrated", fitted)):
            machine.override(model)
            lists[label] = {f"{n}^3 {dt}": pass_schedule.passes((n,) * 3, dt, 16)
                            for n in (512, 1024)
                            for dt in ("float32", "bfloat16")}
    finally:
        machine.override(None)
    for key in lists["DEFAULT"]:
        print(f"  passes of 16 steps at {key}: calibrated "
              f"{lists['calibrated'][key]}, DEFAULT {lists['DEFAULT'][key]}")

    # plan and viz through the CLI: no device is touched
    for argv in (["plan", "--input", str(ROOT / "configs" / "hip.dat")],
                 ["plan", "--input", str(ROOT / "configs" / "hip.dat"),
                  "--variant", "mpi_cuda"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = buf.getvalue()
        print(f"  plan hip.dat {' '.join(argv[3:])}: "
              + " | ".join(out.strip().splitlines()))
        check(rc == 0 and out.startswith("config: n=32768^2"),
              f"{' '.join(argv)} exited {rc}: {out!r}")
        if "--variant" in argv:
            check("mesh:" in out and "halo:" in out and "kernel" in out,
                  f"plan --variant mpi_cuda printed {out!r}")
    dat, png = WORK / "viz.dat", WORK / "viz.png"
    x = np.linspace(0.0, 2.0, 16)
    write_dat(dat, (x, x), 1.0 + np.outer(np.sin(x), np.sin(x)))
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["viz", str(dat), "--save", str(png)])
    if rc == 0:
        check(png.exists() and png.stat().st_size > 0,
              "viz exited 0 without writing its PNG")
        print(f"  viz: wrote {png.stat().st_size} B of PNG")
    else:
        check("matplotlib" in err.getvalue() and not png.exists(),
              f"viz exited {rc} without naming matplotlib: "
              f"{err.getvalue()!r}")
        print(f"  viz: exit {rc}, {err.getvalue().strip()}")
    print(f"[phase 3b] {time.perf_counter() - t0:.1f} s")
    return {"record": rec, "passes": lists, "seconds": cal_s}


def phase_oracle():
    import numpy as np

    from heat_tpu_torch import HeatConfig, parse_input, solve
    from heat_tpu_torch.io import read_dat

    src = ROOT / "configs" / "serial.dat"
    cfg = parse_input(src)
    print(f"[phase 4] configs/serial.dat ({cfg.n}^2, {cfg.ntime} steps) on cuda f32")
    _, launches = cli_run(src.read_text(), "--dtype", "float32", "--soln",
                          "--out", "soln.dat")
    check(launches["ftcs2d"] == 1 + 14 + 2,
          f"{launches['ftcs2d']} launches, expected 17")
    _, got = read_dat(WORK / "soln.dat")
    oracle = solve(cfg.with_(backend="serial", dtype="float32")).T
    check(got.shape == oracle.shape and np.isfinite(got).all(), "bad soln.dat")
    err = float(np.abs(got - oracle).max())
    print(f"  soln.dat vs serial oracle: max|err| {err:g} (atol {F32_ATOL:g})")
    check(err <= F32_ATOL, "cuda solve off the serial oracle")
    errs = {"serial.dat": err}
    for bc in ("edges", "ghost"):
        cfg = HeatConfig(n=64, ndim=3, sigma=0.15, nu=0.05, dom_len=2.0,
                         ntime=50, dtype="float32", bc=bc)
        print(f"[phase 4] 64^3 f32, sigma 0.15, {bc} BC, 50 steps on cuda")
        _, launches = cli_run("64 0.15 0.05 2.0 50\n", "--ndim", "3", "--bc",
                              bc, "--dtype", "float32", "--soln", "--out",
                              "soln.dat")
        check(launches["ftcs3d"] > 0, "no ftcs3d launch")
        _, got = read_dat(WORK / "soln.dat", ndim=3)
        oracle = solve(cfg.with_(backend="serial")).T
        check(got.shape == oracle.shape and np.isfinite(got).all(),
              "bad soln.dat")
        err = float(np.abs(got - oracle).max())
        print(f"  soln.dat vs serial oracle: max|err| {err:g} "
              f"(atol {F32_ATOL:g}), {launches['ftcs3d']} ftcs3d launches")
        check(err <= F32_ATOL, f"3D {bc} cuda solve off the serial oracle")
        errs[f"64^3 {bc}"] = err
    return errs


def supervised_bench(last_good=None) -> tuple:
    """``python -m heat_tpu_torch.bench`` as a child from the repository
    root, its wall budget 300 s, its cache at ``last_good`` (default the
    committed ``labs/artifacts/last_bench.json``): rc 0, a last line
    without ``error`` carrying the metric, the cache written with that
    metric and value. Returns (the record, the child's seconds)."""
    from heat_tpu_torch import bench

    env = {**os.environ, "HEAT_BENCH_TOTAL_BUDGET_S": "300"}
    cache = ROOT / "heat_tpu_torch/labs/artifacts/last_bench.json"
    if last_good is not None:
        env["HEAT_BENCH_LAST_GOOD"] = str(last_good)
        cache = Path(last_good)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "heat_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=330)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and len(lines) >= 1,
          f"python -m heat_tpu_torch.bench exited {out.returncode}: "
          f"{out.stdout[-600:]} {out.stderr[-600:]}")
    rec = json.loads(lines[-1])
    check("error" not in rec and rec["metric"] == bench.METRIC
          and rec["value"] > 0, f"supervised bench line {lines[-1][:300]}")
    cached = json.loads(cache.read_text())
    check(cached["metric"] == bench.METRIC and cached["value"] == rec["value"],
          f"{cache} does not hold the line's record")
    return rec, wall


def phase_bench(smi) -> None:
    """Phase 3c: ``bench`` through the CLI entry point at its card defaults,
    the launch counts zeroed just before and read just after; then the
    supervised entry as a child."""
    import torch

    from heat_tpu_torch import benchmark, cli
    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_stencil as cs
    from heat_tpu_torch.ops import pass_schedule

    print("[phase 3c] python -m heat_tpu_torch bench (4096^2 f32 x 8192, "
          "3 repeats)")
    t0 = time.perf_counter()
    buf = io.StringIO()
    cs.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench"])
    launches = dict(cs.launches)
    out = buf.getvalue()
    print("".join(f"    | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"bench exited {rc}")
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["metric"] == benchmark.metric_name(4096)
          and rec["platform"] == "cuda" and rec["kernel"] == "cuda ftcs2d",
          f"bench record {rec['metric']} {rec['platform']} {rec['kernel']}")
    per_pass = len(pass_schedule.passes((4096, 4096), torch.float32, 16))
    per_call = per_pass * (benchmark.STEPS // 16)
    check(rec["launches_per_call"] == per_call == 512,
          f"bench: {rec['launches_per_call']} launches a call, expected "
          f"{per_call} (512)")
    # the warm-up's one fused call, then every call of the protocol
    check(launches["ftcs2d"] == per_pass + rec["calls"] * per_call
          and launches["ftcs3d"] == 0,
          f"bench launched {launches}, expected {per_pass} + "
          f"{rec['calls']} x {per_call} ftcs2d")
    bound = device_model().peaks.hbm_bytes_per_s / 8
    check(0 < rec["value"] < float("inf") and rec["raw_single_call"] > 0
          and rec["vs_baseline"] == rec["value"] / bound,
          f"bench numbers {rec['value']} {rec['vs_baseline']}")
    print(f"[phase 3c] headline {rec['value']:.6g} points/s (raw single "
          f"call {rec['raw_single_call']:.6g}), vs_baseline "
          f"{rec['vs_baseline']:.6f} of the one-pass-per-step bound "
          f"{bound:.6g} points/s ({rec['baseline_chip']}), "
          f"{rec['launches_per_call']} ftcs2d launches a call, "
          f"{launches['ftcs2d']} in the run on {smi}")
    t_in = time.perf_counter() - t0
    child, wall = supervised_bench(WORK / "last_bench.json")
    print(f"[phase 3c] python -m heat_tpu_torch.bench: rc 0, "
          f"{child['value']:.6g} points/s (raw {child['raw_single_call']:.6g},"
          f" vs_baseline {child['vs_baseline']:.6f}), {wall:.1f} s as a "
          f"child; bench in process {t_in:.1f} s on {smi}")
    torch.cuda.empty_cache()


def phase_chip_check(smi):
    """Phase 4b: the on-card certification lab (``labs/chip_check.py``)
    through its entry point, its record in WORK: every backend x BC x
    dtype x rank case of the reference's chip check at small sizes
    through the backends' own entry points, against the serial oracle
    (5e-6 f32, 5e-2 bf16); all 23 rows ok, ``ftcs2d`` and ``ftcs3d``
    launched."""
    from heat_tpu_torch.labs import chip_check

    print("[phase 4b] python -m heat_tpu_torch.labs.chip_check")
    t0 = time.perf_counter()
    out = WORK / "chip_check.json"
    rc = chip_check.main(["--out", str(out)])
    rec = json.loads(out.read_text())
    launches = rec["launches"]
    print(f"[phase 4b] chip_check: {rec['passed']} of {len(rec['rows'])} rows "
          f"ok, launches {launches}, {rec['seconds']:.1f} s of cases, "
          f"{time.perf_counter() - t0:.1f} s in all on {smi}")
    check(rc == 0 and rec["passed"] == len(rec["rows"]) == 23,
          f"chip_check: {rec['failed']} rows failed (rc {rc})")
    check(launches["ftcs2d"] > 0 and launches["ftcs3d"] > 0,
          f"chip_check did not launch both kernels: {launches}")


def lane_case(nd, B, dtype, k, seed):
    """One phase-2 lane case on the card: (fields, r, n, rem) of 4 lanes."""
    import torch

    L = 4
    m = B + 2
    f = field((L,) + (m,) * nd, dtype, seed)
    f[(3,) + (1 + B // 2,) * nd] = float("nan")
    dev = f.device
    n = torch.tensor([B - 3, B, B, B], dtype=torch.int32, device=dev)
    rem = torch.tensor([k + 3, k // 2 if k > 1 else 0, 0, k + 1],
                       dtype=torch.int32, device=dev)
    r = torch.tensor(LANE_R[nd] + LANE_R[nd][:1], dtype=torch.float32,
                     device=dev)
    return f, r, n, rem


# phase 2: the streamed lanes2d's cases: lanes, sides m = B + 2 (one
# region, 2.7 regions, rows at odd offsets, the main path's buckets) and
# chunk depths (one pass, the tail chunk, the main path's depth, a depth
# other than a pass's, several passes)
LANES2D_L = (1, 3, 8)
LANES2D_B = (12, 128, 129, 256, 1024)
LANES2D_K = (1, 4, 15, 16, 37)
# NaNs whose payload no kernel computes, by dtype (f32 bits, bf16 bits)
QNAN_PAYLOAD = {"float32": 0x7FC00001, "bfloat16": 0x7FC1}


def lane_case_2d(L, B, dtype, k, idx):
    """One streamed-lanes2d case on the card: (fields, r, n, rem). Lane l
    takes role (l + idx) % 4: 0 n = B with steps past the chunk; 1 n = B - 3
    with a NaN of a payload no kernel computes next to its live region's
    edge (row n + 1, read by the live cells under ghost BC, never under
    edges) and one two rows past it (never read: its bytes must survive);
    2 a countdown that ends inside a pass; 3 no step left (a finished
    lane, copied)."""
    import torch

    m = B + 2
    f = field((L, m, m), dtype, seed=1000 + idx)
    n, rem = [], []
    for lane in range(L):
        role = (lane + idx) % 4
        nl = B - 3 if role == 1 else B
        n.append(nl)
        rem.append((k + 3, k + 1, max(1, k // 2 + 1), 0)[role])
        if role == 1:
            for row in (nl + 1, nl + 3):
                if row < m:
                    bits(f)[lane, row, max(1, nl // 2)] = QNAN_PAYLOAD[
                        str(dtype).replace("torch.", "")]
    dev = f.device
    r = torch.tensor([LANE_R[2][lane % 3] for lane in range(L)],
                     dtype=torch.float32, device=dev)
    return (f, r, torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(rem, dtype=torch.int32, device=dev))


# phase 2: the streamed lanes3d's cases: lanes, sides m = B + 2 (B 8, a
# tile edge, a tile edge plus an odd side, two tiles, the main path's
# bucket) and chunk depths (one step, one pass, a pass and a step, the
# deepest pass, several passes ending inside one, the main path's depth,
# many passes)
LANES3D_L = (1, 3, 8)
LANES3D_B = (8, 32, 33, 64, 256)
LANES3D_K = (1, 4, 5, 8, 15, 16, 37)


def lane_case_3d(L, B, dtype, k, idx):
    """One streamed-lanes3d case on the card: (fields, r, n, rem). Lane l
    takes role (l + idx) % 4: 0 n = B with steps past the chunk; 1 n = B - 3
    with NaNs of a payload no kernel computes next to its live region's
    edge on each axis (index n + 1: the row from the streamed planes, the
    mid from the plane buffer, the col from a shuffle; read by the live
    cells under ghost BC, never under edges) and two past it (never read:
    their bytes must survive); 2 a countdown that ends inside a pass; 3 no
    step left (a finished lane, copied)."""
    import torch

    m = B + 2
    f = field((L, m, m, m), dtype, seed=2000 + idx)
    n, rem = [], []
    for lane in range(L):
        role = (lane + idx) % 4
        nl = B - 3 if role == 1 else B
        n.append(nl)
        rem.append((k + 3, k + 1, max(1, k // 2 + 1), 0)[role])
        if role == 1:
            c = max(1, nl // 2)
            for e in (nl + 1, nl + 3):
                if e < m:
                    for cell in ((e, c, c), (c, e, c), (c, c, e)):
                        bits(f)[(lane,) + cell] = QNAN_PAYLOAD[
                            str(dtype).replace("torch.", "")]
    dev = f.device
    r = torch.tensor([LANE_R[3][lane % 3] for lane in range(L)],
                     dtype=torch.float32, device=dev)
    return (f, r, torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(rem, dtype=torch.int32, device=dev))


def export_multistep(kernel, fields, r, n, rem, ksteps, bc_lo, export, depth):
    """``cuda_lanes.lane_multistep`` through an export of ``kernel``'s
    library (``heat_lanes2d`` or its band design ``heat_lanes2d_band``;
    ``heat_lanes3d`` or its one-step design ``heat_lanes3d_step``) in
    passes of up to ``depth`` steps; its launches are not counted."""
    import torch

    from heat_tpu_torch.ops import cuda_lanes as cl

    L = fields.shape[0]
    lib, fn = cl._kernel_fn(kernel, export)
    boundary = torch.empty((cl.K_BOUNDARY, L), dtype=torch.int32,
                           device=fields.device)
    out = cl._launch_passes(lib, fn, export, fields.clone(),
                            torch.empty_like(fields), r, n, rem,
                            torch.empty_like(rem), boundary, ksteps, bc_lo,
                            count=False, depth=depth)
    return out, boundary[1] != 0, boundary[2:cl.K_BOUNDARY].view(torch.float32)


def earlier_multistep(nd, fields, r, n, rem, ksteps, bc_lo):
    """The earlier design of the lane kernel: ``lanes2d``'s band design in
    its own passes of up to 16 steps, ``lanes3d``'s one step a launch."""
    if nd == 2:
        return export_multistep("lanes2d", fields, r, n, rem, ksteps, bc_lo,
                                "heat_lanes2d_band", 16)
    return export_multistep("lanes3d", fields, r, n, rem, ksteps, bc_lo,
                            "heat_lanes3d_step", 1)


EARLIER = {2: "band design", 3: "one-step design"}


def lane_results_agree(what, got, want, other=None, other_name=""):
    """Bytes, finite bits, resid/tmin/tmax (finite lanes) equal, heat
    within a relative 1e-5; and, where given, the earlier design's bytes
    (NaN cells as NaN: lanes2d's band design converts every value again at
    its store, which may rewrite a NaN's payload), finite bits and
    resid/tmin/tmax equal to the kernel's. Returns the max |err| over cells
    finite in both."""
    import torch

    ndiff = int((bits(got[0]) != bits(want[0])).sum())
    fin_ok = torch.equal(got[1], want[1])
    ok = want[1]
    st_ok = torch.equal(got[2][:3, ok], want[2][:3, ok])
    heat = float(((got[2][3, ok] - want[2][3, ok]).abs()
                  / want[2][3, ok].abs()).max()) if bool(ok.any()) else 0.0
    nother = 0
    if other is not None:
        nother = int((~nan_bits_equal_cells(got[0], other[0])).sum())
        fin_ok = fin_ok and torch.equal(got[1], other[1])
        st_ok = st_ok and torch.equal(got[2][:3, ok], other[2][:3, ok])
    if ndiff or nother or not (fin_ok and st_ok) or heat > 1e-5:
        print(f"  {what}: {ndiff} cells differ ({nother} from the "
              f"{other_name}), finite {got[1].tolist()} vs "
              f"{want[1].tolist()}, stats equal {st_ok}, heat rel {heat:g}")
    check(ndiff == 0, f"lane kernel != plain: {what}")
    check(nother == 0, f"lane kernel != its {other_name}: {what}")
    check(fin_ok, f"finite bits differ: {what}")
    check(st_ok, f"resid/tmin/tmax differ: {what}")
    check(heat <= 1e-5, f"heat off by {heat:g}: {what}")
    g, w = got[0].float(), want[0].float()
    both = torch.isfinite(g) & torch.isfinite(w)
    return float((g[both] - w[both]).abs().max()) if bool(both.any()) else 0.0


def phase_lane_compare():
    """lanes2d/lanes3d against their plain versions and their earlier
    designs, bytes, in the shipped passes and in the kernel's deeper ones;
    their launch geometry against ``cuda_lanes.lanes2d_geometry`` /
    ``lanes3d_geometry``. Returns max |err| per (kernel, bucket)."""
    import torch

    from heat_tpu_torch.ops import cuda_lanes as cl

    # the kernel's own deeper passes beside the shipped ones
    deep = {2: ("lanes2d", "heat_lanes2d", 16),
            3: ("lanes3d", "heat_lanes3d", cl.KMAX_3D)}

    def agree(nd, what, f, r, n, rem, k, bc_lo):
        got = cl.lane_multistep(f, r, n, rem, k, bc_lo)
        want = cl.lane_multistep(f, r, n, rem, k, bc_lo, plain=True)
        other = earlier_multistep(nd, f, r, n, rem, k, bc_lo)
        torch.cuda.synchronize()
        err = lane_results_agree(what, got, want, other, EARLIER[nd])
        kernel, export, depth = deep[nd]
        lane_results_agree(
            f"{what} ({depth}-step passes)", export_multistep(
                kernel, f, r, n, rem, k, bc_lo, export, depth), want, other,
            EARLIER[nd])
        return err

    errs = {}
    t0 = time.perf_counter()
    ncases = 0
    for nd, buckets in ((2, (12, 256, 1024)), (3, (8, 64, 256))):
        for B in buckets:
            for dt in (torch.float32, torch.bfloat16):
                for bc_lo in (0, 1):
                    for k in (1, 5, 16, 37):
                        f, r, n, rem = lane_case(nd, B, dt, k, seed=ncases)
                        key = (cl._KERNELS[nd], B)
                        what = (f"{key[0]} B={B} {dt_name(dt)} "
                                f"{('ghost', 'edges')[bc_lo]} k={k}")
                        err = agree(nd, what, f, r, n, rem, k, bc_lo)
                        errs[key] = max(errs.get(key, 0.0), err)
                        ncases += 1
                        del f
            torch.cuda.empty_cache()
    nbase = ncases
    # the streamed kernels' own cases, each also against the earlier design
    own = {2: (LANES2D_L, LANES2D_B, LANES2D_K, lane_case_2d),
           3: (LANES3D_L, LANES3D_B, LANES3D_K, lane_case_3d)}
    nown = {}
    for nd, (Ls, Bs, Ks, make) in own.items():
        for i, (B, k, dt, bc_lo) in enumerate(
                (B, k, dt, bc_lo) for B in Bs for k in Ks
                for dt in (torch.float32, torch.bfloat16) for bc_lo in (0, 1)):
            L = Ls[i % len(Ls)]
            f, r, n, rem = make(L, B, dt, k, i)
            name = cl._KERNELS[nd]
            what = (f"{name} L={L} B={B} {dt_name(dt)} "
                    f"{('ghost', 'edges')[bc_lo]} k={k} rem={rem.tolist()}")
            err = agree(nd, what, f, r, n, rem, k, bc_lo)
            key = (name, B)
            errs[key] = max(errs.get(key, 0.0), err)
            nown[name] = nown.get(name, 0) + 1
            ncases += 1
            del f
        torch.cuda.empty_cache()
    print(f"[phase 2] {ncases} lane-kernel-vs-plain cases ({nbase} base; "
          f"{nown['lanes2d']} of the streamed lanes2d: L {LANES2D_L}, B "
          f"{LANES2D_B}, k {LANES2D_K}; {nown['lanes3d']} of the streamed "
          f"lanes3d: L {LANES3D_L}, B {LANES3D_B}, k {LANES3D_K}; every case "
          f"in the shipped passes of up to {cl.PASS_2D} (2D) / {cl.PASS_3D} "
          f"(3D) steps and in the kernel's deepest, 16 / {cl.KMAX_3D}, and "
          f"against heat_lanes2d_band / heat_lanes3d_step), 0 differing "
          f"bytes, stats equal, heat within 1e-5 "
          f"({time.perf_counter() - t0:.1f} s)")
    # the launch geometry the kernels compute against the Python mirrors
    ngeo = 0
    for nd, kmax, sizes, compiled, mirror in (
            (2, cl.KMAX_2D, ((1, 14), (3, 131), (8, 258), (8, 514),
                             (8, 1026), (1, 4098)),
             cl.compiled_lanes2d_geometry, cl.lanes2d_geometry),
            (3, cl.KMAX_3D, ((1, 10), (3, 35), (8, 66), (8, 258), (1, 1026),
                             (65535, 10)),
             cl.compiled_lanes3d_geometry, cl.lanes3d_geometry)):
        for dt in (torch.float32, torch.bfloat16):
            for k in range(1, kmax + 1):
                for L, m in sizes:
                    got, slots = compiled(dt, L, m, k)
                    want = mirror(L, m, k, slots)
                    check(got == want, f"{cl._KERNELS[nd]} geometry "
                                       f"{dt_name(dt)} L={L} m={m} k={k}: "
                                       f"kernel {got} != mirror {want} at "
                                       f"{slots} slots")
                    ngeo += 1
    main2, slots2 = cl.compiled_lanes2d_geometry(torch.float32, 8, 1026, 16)
    main3 = {dt: cl.compiled_lanes3d_geometry(dt, 8, 258, cl.PASS_3D)
             for dt in (torch.float32, torch.bfloat16)}
    print(f"  launch geometry equal to cuda_lanes.lanes2d_geometry / "
          f"lanes3d_geometry in {ngeo} cases (k = 1..16 / 1..8, f32/bf16); "
          f"lanes2d 8x1026^2 f32 k=16 on {slots2} resident blocks: {main2}; "
          + "; ".join(f"lanes3d 8x258^3 {dt_name(dt)} k={cl.PASS_3D} on "
                      f"{sl} resident blocks: {g}"
                      for dt, (g, sl) in main3.items()))
    return errs


def phase_lane_times():
    """One serving chunk (``lane_chunk``: the stats init and the kernel
    passes: two 8-step passes in 2D, four 4-step passes in 3D) of 8 lanes
    at the main path's buckets: kernel and plain version, and the bound: the
    stack read and written once against 7 (2D) or 9 (3D) f32 operations per
    live cell-step (every lane n = B under edges BC: (B-2)^nd live cells,
    each stepped k times); beside it the bound at the reference's
    CostEstimate count over every cell. Beside the chunk, in turns (kernel,
    earlier, earlier, kernel): the earlier design (2D the band, one 16-step
    pass; 3D one step a launch); then the kernel in its deepest passes (2D
    one of 16 steps, 3D two of 8) and the device time per chunk of kernel
    and earlier design from ``torch.profiler``; in 3D the chunk in passes
    of every depth 1..8 (the sweep that sets ``cuda_lanes.PASS_3D``), each
    held to the plain version's bytes."""
    import torch

    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_lanes as cl

    dm = device_model(0)
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    L = 8
    for nd, B, dt, k, reps in ((2, 256, f32, 16, 200), (2, 512, f32, 16, 100),
                               (2, 1024, f32, 16, 50), (2, 1024, bf16, 16, 50),
                               (3, 256, f32, 16, 20), (3, 256, bf16, 16, 20)):
        m = B + 2
        A = field((L,) + (m,) * nd, dt, seed=B)
        S = torch.empty_like(A)
        dev = A.device
        n = torch.full((L,), B, dtype=torch.int32, device=dev)
        rem = torch.full((L,), 1 << 30, dtype=torch.int32, device=dev)
        rem_out = torch.empty_like(rem)
        r = torch.tensor((LANE_R[nd] * 3)[:L], dtype=torch.float32, device=dev)
        bnd = torch.empty((cl.K_BOUNDARY, L), dtype=torch.int32, device=dev)
        name = cl._KERNELS[nd]

        def chunk(plain):
            return cl.lane_chunk(A, S, r, n, rem, rem_out, bnd, k, 1,
                                 plain=plain)

        def via(export, depth):
            lib, fn = cl._kernel_fn(name, export)
            return lambda: cl._launch_passes(
                lib, fn, export, A, S, r, n, rem, rem_out, bnd, k, 1,
                count=False, depth=depth)

        bound_s, bound_by = dm.pass_bound_s(
            A.numel(), A.element_size(), k, ndim=nd,
            op_points=L * (B - 2) ** nd)
        bytes_s, _ = dm.pass_bound_s(A.numel(), A.element_size(), k,
                                     ndim=nd, op_points=0)
        ce_s = max(bytes_s, LANE_COST_ESTIMATE_OPS[nd] * A.numel() * k
                   / dm.peaks.f32_flops_per_s)
        depth = cl.PASS_2D if nd == 2 else cl.PASS_3D
        pass_s, pass_by = dm.pass_bound_s(
            A.numel(), A.element_size(), depth, ndim=nd,
            op_points=L * (B - 2) ** nd)
        # the sweep's inputs and the plain version's chunk, before the
        # timed chunks overwrite A
        A0 = A.clone() if nd == 3 else None
        want = (cl.lane_multistep(A0, r, n, rem, k, 1, plain=True)
                if nd == 3 else None)
        earlier = (via("heat_lanes2d_band", 16) if nd == 2
                   else via("heat_lanes3d_step", 1))
        ms_a = event_ms(lambda: chunk(False), reps)
        old_a, old_b = event_ms(earlier, reps), event_ms(earlier, reps)
        ms = (ms_a + event_ms(lambda: chunk(False), reps)) / 2
        old_ms = (old_a + old_b) / 2
        deep_ms = event_ms(via(f"heat_{name}",
                               16 if nd == 2 else cl.KMAX_3D), reps)
        dev_ms = device_ms(lambda: chunk(False), reps)
        old_dev_ms = device_ms(earlier, reps)
        plain_ms = event_ms(lambda: chunk(True), 1)
        sweep = {}
        if nd == 3:
            for d in range(1, cl.KMAX_3D + 1):
                sweep[d] = event_ms(via("heat_lanes3d", d), reps)
                got = export_multistep("lanes3d", A0, r, n, rem, k, 1,
                                       "heat_lanes3d", d)
                lane_results_agree(f"lanes3d {L}x{m}^3 {dt_name(dt)} k={k} "
                                   f"in {d}-step passes", got, want)
                del got
            del A0, want
        times[(name, B, dt)] = dict(
            k=k, ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
            bound_by=bound_by, cost_estimate_bound_ms=ce_s * 1e3,
            pass_depth=depth, pass_bound_ms=pass_s * 1e3, pass_bound_by=pass_by,
            device_ms=dev_ms, **{
                2: dict(band_ms=old_ms, one_pass_ms=deep_ms,
                        band_device_ms=old_dev_ms),
                3: dict(step_ms=old_ms, pass8_ms=deep_ms,
                        step_device_ms=old_dev_ms,
                        sweep_ms={d: t for d, t in sweep.items()})}[nd])
        print(f"  {name} {L}x{m}^{nd} {dt_name(dt)} k={k}: {ms:.4f} ms/chunk "
              f"in passes of {depth} (plain {plain_ms:.2f} ms, bound "
              f"{bound_s * 1e3:.4f} ms by {bound_by}, "
              f"{bound_s * 1e3 / ms:.1%} of it; a {depth}-step pass's bound "
              f"{pass_s * 1e3:.4f} ms by {pass_by}; at the reference's "
              f"CostEstimate count {ce_s * 1e3:.4f} ms), {EARLIER[nd]} "
              f"{old_ms:.4f} ms ({bound_s * 1e3 / old_ms:.1%} of the bound; "
              f"kernel {ms_a:.4f} / earlier {old_a:.4f} / {old_b:.4f} in "
              f"turns), {old_ms / ms:.2f}x; the kernel in passes of "
              f"{16 if nd == 2 else cl.KMAX_3D} {deep_ms:.4f} ms; device time "
              f"per chunk (torch.profiler) {fmt_ms(dev_ms)}, {EARLIER[nd]} "
              f"{fmt_ms(old_dev_ms)}")
        if sweep:
            print(f"    {name} {L}x{m}^3 {dt_name(dt)} chunk of {k} steps in "
                  f"passes of d (0 differing bytes from the plain version at "
                  f"each d): " + ", ".join(
                      f"d={d} {t:.4f} ms "
                      f"({t / len(cl.passes(3, k, d)):.4f} ms/launch)"
                      for d, t in sweep.items()))
        del A, S
        torch.cuda.empty_cache()
    print("[phase 2] lane times taken")
    return times


def serve_population(path: Path) -> list:
    """Phase 5's requests, written to ``path`` as JSON lines; returns them."""
    import numpy as np

    rng = np.random.default_rng(0)
    ics = ICS

    def ntime(lo, hi):
        while True:
            t = int(rng.integers(lo, hi + 1))
            if t % 16:
                return t

    reqs = []
    for i in range(40):
        reqs.append(dict(id=f"f32-{i:02d}", n=int(rng.integers(128, 1025)),
                         ntime=ntime(1000, 8000), dtype="float32",
                         sigma=float(rng.choice(LANE_R[2])),
                         bc=("edges", "ghost")[i % 2], bc_value=1.0,
                         ic=ics[i % 4]))
    for i in range(8):        # bf16 twins of every fifth f32 request
        reqs.append(dict(reqs[5 * i], id=f"bf16-{i}", dtype="bfloat16"))
    for i in range(8):
        reqs.append(dict(id=f"3d-{i}", ndim=3, n=int(rng.integers(64, 257)),
                         ntime=ntime(100, 800), dtype="float32",
                         sigma=float(rng.choice(LANE_R[3])),
                         bc=("edges", "ghost")[i % 2], bc_value=1.0,
                         ic=ics[i % 4]))
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return reqs


def cli_serve_rows(reqfile: Path, out_dir: Path, *extra, echo=True):
    """One ``serve`` through the CLI entry point, the lane launch counts
    zeroed just before and read just after (and the fault plans' firing
    state reset). Returns (rc, every JSON row printed, summary, launches by
    kernel, wall seconds)."""
    from heat_tpu_torch import cli
    from heat_tpu_torch.ops import cuda_lanes as cl
    from heat_tpu_torch.runtime import faults

    buf = io.StringIO()
    faults.reset()
    cl.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", "--requests", str(reqfile), "--out-dir",
                       str(out_dir), "--json", *SERVE_ARGS, *extra])
    wall = time.perf_counter() - t0
    launches = dict(cl.launches)
    lines = buf.getvalue().splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    summary = rows[-1]     # the last JSON line (a --trace note follows it)
    if echo:
        print("".join(f"    | {x}\n" for x in lines
                      if not x.startswith('{"bc"')
                      and not x.startswith('{"event": "steady_state"')),
              end="")
    return rc, rows, summary, launches, wall


def cli_serve(reqfile: Path, out_dir: Path, *extra):
    """``cli_serve_rows`` with the ``serve_request`` records only. Returns
    (rc, records, summary, launches by kernel, wall seconds)."""
    rc, rows, summary, launches, wall = cli_serve_rows(reqfile, out_dir,
                                                       *extra)
    records = [r for r in rows if r.get("event") == "serve_request"]
    return rc, records, summary, launches, wall


def npz_differ(ids, a: Path, b: Path) -> list:
    """The ids whose ``<id>.npz`` in ``a`` and ``b`` are not byte-equal."""
    return [i for i in ids
            if (a / f"{i}.npz").read_bytes() != (b / f"{i}.npz").read_bytes()]


def start_plain_serve():
    """Phase 5's file served with ``--serve-lane-kernel torch`` (the plain
    lane body, which builds and launches no kernel) in a child process, so
    that it runs beside phases 1 and 2's untimed work. Returns the child;
    ``plain_serve_result`` waits for it."""
    serve_population(WORK / "requests.jsonl")
    log = open(WORK / "serve-torch.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke as c; c.plain_serve_child()"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def plain_serve_child() -> None:
    """The child of ``start_plain_serve``: the serve and its launch counts,
    written to ``serve-torch.json``."""
    rc, recs, summary, launches, wall = cli_serve(
        WORK / "requests.jsonl", WORK / "serve-torch", "--serve-lane-kernel",
        "torch")
    (WORK / "serve-torch.json").write_text(json.dumps(dict(
        rc=rc, records=recs, summary=summary, launches=launches, wall=wall)))


def plain_serve_result(child, timeout: float = 600.0) -> dict:
    """Wait for ``child`` (``start_plain_serve``) and return its result;
    a child that fails, or outlasts ``timeout`` (killed then), fails the
    phase."""
    t0 = time.perf_counter()
    try:
        rc = child.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        rc = None
    log = (WORK / "serve-torch.log").read_text()
    res = WORK / "serve-torch.json"
    check(rc == 0 and res.exists(),
          f"the plain serve child exited {rc}:\n{log[-4000:]}")
    out = json.loads(res.read_text())
    out["log"] = log
    print(f"[phase 2] the plain serve child (phase 5's comparison run) "
          f"done, waited {time.perf_counter() - t0:.1f} s for it")
    return out


def phase_serve(smi, plain=None):
    """The serve main path on the card (see the module docstring).
    ``plain`` is the ``--serve-lane-kernel torch`` run's result
    (``plain_serve_result``); without it the run is made here."""
    import numpy as np

    from heat_tpu_torch import HeatConfig, solve
    from heat_tpu_torch.ops import cuda_lanes as cl
    from heat_tpu_torch.serve.engine import bf16_to_float32

    reqfile = WORK / "requests.jsonl"
    reqs = serve_population(reqfile)
    ids = [r["id"] for r in reqs]
    by_id = {r["id"]: r for r in reqs}
    out_k, out_t = WORK / "serve-cuda", WORK / "serve-torch"
    print(f"[phase 5] serve {len(reqs)} requests: {' '.join(SERVE_ARGS)}")
    rc, recs, summary, launches, wall = cli_serve(reqfile, out_k)
    check(rc == 0, f"serve exited {rc}")
    check(len(recs) == len(reqs) and all(r["status"] == "ok" for r in recs),
          "not every request served ok")
    check(summary["lane_kernel_fallbacks"] == 0, "a bucket fell back to torch")
    passes = summary["lane_passes"]
    check(launches == {k: passes.get(k, 0) for k in launches},
          f"lane launches {launches} != the dispatched chunks' passes {passes}")
    check(launches["lanes2d"] > 0 and launches["lanes3d"] > 0,
          f"serve did not launch both lane kernels: {launches}")
    # the launches by bucket, from the scheduler's count of the dispatched
    # chunks' passes (whose totals the wrappers' counts just matched)
    by_bucket = summary["lane_passes_by_bucket"]
    cell_steps = sum(r["n"] ** r.get("ndim", 2) * r["ntime"] for r in reqs)
    rate = cell_steps / wall
    print(f"  served {len(recs)} requests, {cell_steps} cell-steps in "
          f"{wall:.3f} s: {rate:.6g} cell-steps/s; "
          f"{summary['chunks_dispatched']} chunks ({summary['tail_chunks']} "
          f"tail), boundary_wait_s {summary['boundary_wait_s']}, est. device "
          f"idle {summary['device_idle_s']} s, launches {launches} on {smi}")
    for bucket, count in by_bucket.items():
        print(f"    {count} launches of {bucket}")
    # launches per chunk by kernel: a chunk of at most 16 steps (--chunk) is
    # at most len(passes(nd, 16)) launches
    chunks = summary["lane_chunks"]
    for name, nd in (("lanes2d", 2), ("lanes3d", 3)):
        most = len(cl.passes(nd, int(SERVE_ARGS[3])))
        print(f"  {name}: {launches[name]} launches in {chunks[name]} chunks,"
              f" {launches[name] / chunks[name]:.4f} a chunk (at most {most})")
        check(launches[name] <= most * chunks[name],
              f"{name} took over {most} launches a chunk")

    profile = profiled_serve(reqfile, WORK / "serve-profiled", wall, ids, out_k)

    print("[phase 5] the same file with --serve-lane-kernel torch (the plain "
          "versions, on the card)" + (", in a child process beside phases "
                                      "1 and 2" if plain else ""))
    if plain is None:
        rc_t, recs_t, summary_t, launches_t, wall_t = cli_serve(
            reqfile, out_t, "--serve-lane-kernel", "torch")
    else:
        print(plain["log"], end="")
        rc_t, recs_t, summary_t, launches_t, wall_t = (
            plain["rc"], plain["records"], plain["summary"],
            plain["launches"], plain["wall"])
    check(rc_t == 0 and len(recs_t) == len(reqs)
          and all(r["status"] == "ok" for r in recs_t),
          "torch lane body run failed")
    check(not any(launches_t.values()) and not summary_t["lane_passes"],
          f"torch body launched {launches_t}")
    ndiff = npz_differ(ids, out_k, out_t)
    print(f"  {len(reqs) - len(ndiff)} of {len(reqs)} npz files byte-equal "
          f"(torch body {wall_t:.3f} s, {cell_steps / wall_t:.6g} "
          f"cell-steps/s" + (", beside phases 1 and 2)" if plain else ")"))
    check(not ndiff, f"npz differ from the plain versions' run: {ndiff}")

    def field_of(rid):
        with np.load(out_k / f"{rid}.npz") as z:
            T = z["T"]
        return bf16_to_float32(T) if T.dtype == np.dtype("V2") else T

    def cost(r):
        return r["n"] ** r.get("ndim", 2) * r["ntime"]

    def config(r):
        return HeatConfig(**{k: v for k, v in r.items() if k != "id"})

    small = (sorted((r for r in reqs if r["dtype"] == "float32"
                     and r.get("ndim", 2) == 2), key=cost)[:4]
             + sorted((r for r in reqs if r.get("ndim", 2) == 3), key=cost)[:2])
    oracle_errs = {}
    for r in small:
        cfg = config(r)
        want = solve(cfg.with_(backend="serial")).T
        got = field_of(r["id"])
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"bad field {r['id']}")
        err = float(np.abs(got - want).max())
        atol = F32_ATOL * cfg.ntime / 30
        oracle_errs[r["id"]] = err
        print(f"  {r['id']} ({cfg.n}^{cfg.ndim}, {cfg.ntime} steps, sigma "
              f"{cfg.sigma:.6g}, {cfg.bc}) vs serial oracle: max|err| "
              f"{err:g} (atol {atol:g} = 5e-6 per 30 steps)")
        check(err <= atol, f"{r['id']} off the serial oracle")
    # every field inside the discrete maximum principle's envelope: the
    # initial conditions and bc_value lie in [1, 2], and an FTCS step at
    # sigma <= 1/(2 ndim) is a convex combination (an ulp of rounding aside)
    for r in reqs:
        T = field_of(r["id"])
        lo, hi = float(T.min()), float(T.max())
        check(1.0 - ENVELOPE_TOL <= lo and hi <= 2.0 + ENVELOPE_TOL,
              f"{r['id']} left the [1, 2] envelope: [{lo!r}, {hi!r}]")
    print(f"  all {len(reqs)} fields inside the [1, 2] envelope "
          f"(+-{ENVELOPE_TOL:g})")
    # bf16 against f32: a measurement, not a check. The lanes round to bf16
    # after EVERY step (the reference's lane programs do), so a cell stops
    # moving once its update is under half a bf16 ulp (2^-8 on [1, 2)) and
    # over thousands of steps the bf16 field stagnates behind the f32 one.
    # Beside each gap stand the planted faults' readings: how far the f32
    # request's field lies from an f32 solve (on the card) of the same
    # request with another sigma or another initial condition, that is, the
    # gap a lane that took another request's r or IC would show. Where the
    # stagnation gap is the larger, no limit on it tells such a fault apart;
    # the bf16 lanes are held to the plain body's bytes above instead (and,
    # in the CPU tests, to the JAX engine's).
    drift = {}
    for i in range(8):
        twin = by_id[f"bf16-{i}"]
        src = next(r for r in reqs if r["dtype"] == "float32"
                   and all(r.get(k) == twin.get(k) for k in
                           ("n", "ntime", "sigma", "bc", "ic")))
        f32 = field_of(src["id"]).astype(np.float64)
        d = float(np.mean(np.abs(field_of(twin["id"]) - f32)))
        planted = {}
        for key, values in (("sigma", LANE_R[2]), ("ic", ICS)):
            for v in values:
                if v != src[key]:
                    T = solve(config(dict(src, **{key: v})).with_(
                        backend="cuda"), device="cuda").T
                    planted[f"{key} {v:.6g}" if key == "sigma"
                            else f"{key} {v}"] = float(np.mean(np.abs(T - f32)))
        drift[twin["id"]] = dict(gap=d, planted=planted)
        print(f"  {twin['id']} ({twin['n']}^2, {twin['ntime']} steps, sigma "
              f"{twin['sigma']:.6g}, {twin['ic']}) vs {src['id']}: mean |dT| "
              f"{d:.6g}; planted faults in f32: "
              + ", ".join(f"{k} {v:.6g}" for k, v in planted.items()))
    return dict(launches=launches, by_bucket=by_bucket, summary=summary,
                records=recs,
                wall_s=wall, cell_steps_per_s=rate, oracle_errs=oracle_errs,
                bf16_drift=drift, profile=profile)


def profiled_serve(reqfile: Path, out_dir: Path, wall: float, ids: list,
                   ref_dir: Path, label: str = "[phase 5]"):
    """The kernel-body serve once more under ``torch.profiler``: the card's
    busy time by kernel (the unprofiled run's wall is the denominator of the
    busy share, since profiling slows the host) and the host's heaviest
    calls. The run is checked as the first one is (exit code, every record
    ok) and its npz files must be byte-equal to the first run's; only the
    profiler's own steps report "not measured" where they fail."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"{label} the same file once more under torch.profiler")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  device busy share: not measured (the profiler did not "
              f"start: {type(e).__name__}: {e})")
        prof = None
    rc, recs, _, _, pwall = cli_serve(reqfile, out_dir)
    check(rc == 0, f"profiled serve exited {rc}")
    check(len(recs) == len(ids) and all(r["status"] == "ok" for r in recs),
          "not every request of the profiled serve ok")
    ndiff = npz_differ(ids, out_dir, ref_dir)
    check(not ndiff, f"profiled serve's npz differ from the first run's: "
                     f"{ndiff}")
    print(f"  {len(ids)} of {len(ids)} npz files byte-equal to the first "
          f"run's")
    if prof is None:
        return None
    try:
        prof.stop()
        torch.cuda.synchronize()
        rows = prof.key_averages()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  device busy share: not measured ({type(e).__name__}: {e})")
        return None

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))

    device = sorted(((dev_us(e), e.key, e.count) for e in rows
                     if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                    reverse=True)
    busy_s = sum(t for t, _, _ in device) / 1e6
    if busy_s <= 0:
        print("  device busy share: not measured (the profiler recorded no "
              "device time)")
        return None
    print(f"  device busy {busy_s:.6f} s: {busy_s / wall:.1%} of the "
          f"unprofiled serve's {wall:.3f} s wall ({busy_s / pwall:.1%} of "
          f"the profiled {pwall:.3f} s)")
    for t, key, count in device[:6]:
        print(f"    device {t / 1e6:.6f} s in {count} x {key[:60]}")
    # the serve kernels by name, every instance summed
    by_kernel = {}
    for name, pattern in SERVE_KERNELS.items():
        hits = [(t, c) for t, key, c in device if re.search(pattern, key)]
        by_kernel[name] = (sum(t for t, _ in hits) / 1e6,
                           sum(c for _, c in hits))
        print(f"    {name}: device {by_kernel[name][0]:.6f} s in "
              f"{by_kernel[name][1]} launches ({len(hits)} instances)")
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in rows
                   if e.device_type == DeviceType.CPU), reverse=True)
    for t, key, count in host[:8]:
        print(f"    host {t / 1e6:.6f} s in {count} x {key[:60]}")
    return dict(busy_s=busy_s, busy_share=busy_s / wall,
                profiled_wall_s=pwall, by_kernel=by_kernel,
                device=[(key, t / 1e6, count) for t, key, count in device[:6]])



def tol_for(cfg, frac: float) -> float:
    """The steady tolerance whose closed-form admission prediction
    (``convergence.predict_admission_steps``) is ``frac * ntime`` steps."""
    import math

    from heat_tpu_torch.grid import ic_envelope
    from heat_tpu_torch.runtime import convergence

    lam = math.exp(convergence.closed_form_log_rate(cfg))
    lo, hi = ic_envelope(cfg)
    r0 = (1 - lam) * max(abs(hi), abs(lo), abs(hi - lo))
    return r0 * lam ** (frac * cfg.ntime)


def steady_population(path: Path) -> list:
    """Phase 5b's steady population, written to ``path``: 24 until=steady
    requests from ``default_rng(1)`` (20 2D, sides 128-1024; 4 3D, sides
    64-256; f32 and bf16 in 2D, sine and hat ICs, edges and ghost BCs in
    turn), each ``tol`` picked so that the admission prediction lands
    between 25% and 75% of ``ntime``, and 4 fixed-step twins."""
    import numpy as np

    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.runtime import convergence

    rng = np.random.default_rng(1)
    reqs = []
    for i in range(24):
        three = i >= 20
        r = dict(id=f"steady-{i:02d}", ndim=3 if three else 2,
                 n=int(rng.integers(64, 257) if three
                       else rng.integers(128, 1025)),
                 ntime=int(rng.integers(48, 161) if three
                           else rng.integers(300, 1801)),
                 dtype="bfloat16" if i % 3 == 2 and not three else "float32",
                 sigma=float(rng.choice(LANE_R[3 if three else 2])),
                 ic=("sine", "hat")[i % 2], bc=("edges", "ghost")[(i // 2) % 2],
                 bc_value=1.0)
        cfg = HeatConfig(**{k: v for k, v in r.items() if k != "id"})
        frac = float(rng.uniform(0.3, 0.7))
        r.update(until="steady", tol=tol_for(cfg, frac))
        pred = convergence.predict_admission_steps(cfg, r["tol"])
        check(pred is not None
              and 0.25 * cfg.ntime <= pred <= 0.75 * cfg.ntime,
              f"{r['id']}: predicted {pred} of {cfg.ntime} steps")
        reqs.append(r)
    for i in range(4):
        twin = {k: v for k, v in reqs[5 * i].items() if k not in ("until",
                                                                  "tol")}
        reqs.append(dict(twin, id=f"fixed-{i}"))
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return reqs


def chaos_population(path: Path) -> list:
    """Phase 5b's fault population (``default_rng(2)``): four 2D f32
    requests and two 3D f32 requests, fixed-step."""
    import numpy as np

    rng = np.random.default_rng(2)
    reqs = []
    for i in range(6):
        three = i >= 4
        reqs.append(dict(id=f"chaos-{i}", ndim=3 if three else 2,
                         n=int(rng.integers(64, 129) if three
                               else rng.integers(128, 401)),
                         ntime=int(rng.integers(48, 97) if three
                                   else rng.integers(300, 601)),
                         dtype="float32",
                         sigma=float(rng.choice(LANE_R[3 if three else 2])),
                         ic=ICS[i % 4], bc=("edges", "ghost")[i % 2],
                         bc_value=1.0))
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return reqs


def numerics_calls():
    """Record every ``NumericsObservatory.observe`` call of the runs inside
    the context: (request id, resid, tmin, tmax, heat, remaining)."""
    from heat_tpu_torch.runtime import numerics

    calls = []
    orig = numerics.NumericsObservatory.observe

    def spy(self, req_id, resid, tmin, tmax, heat, remaining):
        calls.append((req_id, resid, tmin, tmax, heat, remaining))
        return orig(self, req_id, resid, tmin, tmax, heat, remaining)

    @contextlib.contextmanager
    def ctx():
        numerics.NumericsObservatory.observe = spy
        try:
            yield calls
        finally:
            numerics.NumericsObservatory.observe = orig

    return ctx()


def events_of(rows, kind):
    return sorted((json.dumps(r, sort_keys=True) for r in rows
                   if r.get("event") == kind))


def launches_are_the_chunks(what, launches, summary):
    """The wrappers' launch counts equal the passes of the dispatched
    chunks (no lane kernel beyond the chunks), and a chunk is at most
    ``len(passes(nd, 16))`` launches of its kernel."""
    from heat_tpu_torch.ops import cuda_lanes as cl

    passes = summary["lane_passes"]
    check(launches == {k: passes.get(k, 0) for k in launches},
          f"{what}: lane launches {launches} != the chunks' passes {passes}")
    for name, nd in (("lanes2d", 2), ("lanes3d", 3)):
        chunks = summary["lane_chunks"].get(name, 0)
        most = len(cl.passes(nd, int(SERVE_ARGS[3])))
        check(launches[name] <= most * chunks,
              f"{what}: {name} took over {most} launches a chunk")
    return {name: launches[name] / max(1, summary["lane_chunks"].get(name, 0))
            for name in launches}


def numerics_ab(serve, pairs: int = 1):
    """Phase 5's file again with ``--numerics off`` and on, ``pairs``
    times in turns (off, on, then on, off, ...; phase 5's first run was
    on): the same boundary fetches and npz bytes, and every wall on one
    card."""
    reqfile = WORK / "requests.jsonl"
    ids = [json.loads(x)["id"] for x in reqfile.read_text().splitlines()]
    walls = {"on": [serve["wall_s"]], "off": []}
    waits = {serve["summary"]["boundary_waits"]}
    for i in range(pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            rc, recs, summary, _, wall = cli_serve(
                reqfile, WORK / f"serve-n{mode}", "--numerics", mode)
            check(rc == 0 and all(r["status"] == "ok" for r in recs),
                  f"--numerics {mode} serve failed")
            check(not npz_differ(ids, WORK / "serve-cuda",
                                 WORK / f"serve-n{mode}"),
                  f"--numerics {mode} npz differ from phase 5's")
            waits.add(summary["boundary_waits"])
            walls[mode].append(wall)
    check(len(waits) == 1, f"boundary fetches differ on/off: {waits}")
    print(f"[phase 5b] phase 5's file, numerics on (phase 5's run first): "
          + ", ".join(f"{w:.3f}" for w in walls["on"]) + " s; off: "
          + ", ".join(f"{w:.3f}" for w in walls["off"])
          + f" s of wall; {waits.pop()} boundary fetches each, npz "
          f"byte-equal")
    return walls


def phase_serve_semantics(smi, serve=None):
    """Phase 5b: serving semantics on the card at phase 5's SERVE_ARGS (see
    the module docstring). ``serve``: phase 5's result, for the numerics
    on/off comparison on its file."""
    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.serve import Engine, ServeConfig

    t_phase = time.perf_counter()
    out = {}
    if serve is not None:
        out["numerics_walls"] = numerics_ab(serve)
    # --- the steady population, on the kernels and on the plain versions
    reqfile = WORK / "steady.jsonl"
    reqs = steady_population(reqfile)
    ids = [r["id"] for r in reqs]
    by_id = {r["id"]: r for r in reqs}
    runs = {}
    for body in ("cuda", "torch"):
        with numerics_calls() as calls:
            rc, rows, summary, launches, wall = cli_serve_rows(
                reqfile, WORK / f"steady-{body}", "--serve-lane-kernel", body,
                echo=False)
        recs = {r["id"]: r for r in rows if r.get("event") == "serve_request"}
        check(rc == 0 and len(recs) == len(reqs)
              and all(r["status"] == "ok" for r in recs.values()),
              f"steady population on {body}: rc {rc}, statuses "
              f"{sorted({r['status'] for r in recs.values()})}")
        runs[body] = dict(rows=rows, recs=recs, summary=summary,
                          launches=launches, wall=wall, calls=list(calls))
    k, t = runs["cuda"], runs["torch"]
    check(not any(t["launches"].values()), f"torch body launched "
                                           f"{t['launches']}")
    per_chunk = launches_are_the_chunks("steady population", k["launches"],
                                        k["summary"])
    for rid in ids:
        a, b = k["recs"][rid], t["recs"][rid]
        check((a["status"], a["exit"], a["steps_done"], a["predicted_steps"])
              == (b["status"], b["exit"], b["steps_done"],
                  b["predicted_steps"]),
              f"{rid}: kernels {a['exit']}@{a['steps_done']} vs plain "
              f"{b['exit']}@{b['steps_done']}")
    ndiff = npz_differ(ids, WORK / "steady-cuda", WORK / "steady-torch")
    check(not ndiff, f"steady npz differ between kernels and plain: {ndiff}")
    st_k, st_t = (events_of(x["rows"], "steady_state") for x in (k, t))
    check(st_k == st_t, "steady_state events differ between the kernels "
                        "and the plain versions")
    vk, vt = (events_of(x["rows"], "numerics_violation") for x in (k, t))
    if vk != vt:
        for line in sorted(set(vk) ^ set(vt)):
            print(f"  numerics_violation in one run only: {line}")
    check(vk == vt, "numerics_violation (heat-jump) events differ between "
                    "the kernels and the plain versions")
    # the fused stats rows the observatory read: resid/tmin/tmax (order-free
    # reductions) and the countdown equal, heat (a sum) within 1e-5
    check(len(k["calls"]) == len(t["calls"]),
          f"{len(k['calls'])} vs {len(t['calls'])} observed boundaries")
    heat_rel = 0.0
    for a, b in zip(sorted(k["calls"], key=lambda c: (c[0], -c[5])),
                    sorted(t["calls"], key=lambda c: (c[0], -c[5]))):
        check(a[:4] == b[:4] and a[5] == b[5],
              f"observed stats differ: {a} vs {b}")
        rel = abs(a[4] - b[4]) / max(abs(b[4]), 1e-30)
        heat_rel = max(heat_rel, rel)
    check(heat_rel <= 1e-5, f"heat differs by {heat_rel:g} relative")
    done = sum(by_id[r]["n"] ** by_id[r]["ndim"] * k["recs"][r]["steps_done"]
               for r in ids)
    saved = k["summary"]["steps_saved"]
    exits = [r for r in ids if k["recs"][r]["exit"] == "steady"]
    print(f"[phase 5b] steady population: {len(reqs)} requests, "
          f"{len(exits)} steady exits, steps_saved {saved}, "
          f"{len(st_k)} steady_state records, {len(vk)} violations; "
          f"kernels {k['wall']:.3f} s ({done / k['wall']:.6g} cell-steps/s "
          f"on the steps done), plain {t['wall']:.3f} s; "
          f"{len(k['calls'])} observed boundaries, heat max rel "
          f"{heat_rel:.3g}; launches {k['launches']} "
          f"({', '.join(f'{n} {v:.3f}' for n, v in per_chunk.items())} a "
          f"chunk) on {smi}")
    for rid in ids:
        a = k["recs"][rid]
        print(f"    {rid} {by_id[rid]['n']}^{by_id[rid]['ndim']} "
              f"{by_id[rid]['dtype']} {by_id[rid]['ic']} {by_id[rid]['bc']}: "
              f"predicted {a['predicted_steps']}, retired {a['exit']} at "
              f"{a['steps_done']} of {a['ntime']}")
    check(saved > 0 and exits, "no steady exit in the steady population")
    profile = profiled_serve(reqfile, WORK / "steady-profiled", k["wall"],
                             ids, WORK / "steady-cuda", label="[phase 5b]")
    out["steady"] = dict(requests=len(reqs), steady_exits=len(exits),
                         steps_saved=saved, wall_s=k["wall"],
                         plain_wall_s=t["wall"],
                         cell_steps_per_s=done / k["wall"],
                         heat_rel=heat_rel, profile=profile,
                         launches_per_chunk=per_chunk)

    # --- rollback: lane-nan into one 2D and one 3D request, depths 0 and 2
    chaos = WORK / "chaos.jsonl"
    creqs = chaos_population(chaos)
    cids = [r["id"] for r in creqs]
    rc, recs, summary, launches, _ = cli_serve(chaos, WORK / "chaos-clean")
    check(rc == 0 and all(r["status"] == "ok" for r in recs),
          "clean chaos run failed")
    clean_pc = launches_are_the_chunks("clean", launches, summary)
    spec = "lane-nan@100:req=chaos-1,lane-nan@20:req=chaos-4"
    for depth in ("2", "off"):
        rc, recs, summary, launches, _ = cli_serve(
            chaos, WORK / f"chaos-rb-{depth}", "--serve-on-nan", "rollback",
            "--inject", spec, "--dispatch-depth", depth)
        check(rc == 0 and all(r["status"] == "ok" for r in recs),
              f"rollback run (depth {depth}) did not heal every request")
        check(summary["rollbacks"] == 2, f"depth {depth}: "
                                         f"{summary['rollbacks']} rollbacks")
        ndiff = npz_differ(cids, WORK / "chaos-clean",
                           WORK / f"chaos-rb-{depth}")
        check(not ndiff, f"rollback (depth {depth}) npz differ: {ndiff}")
        rb_pc = launches_are_the_chunks(f"rollback depth {depth}", launches,
                                        summary)
        print(f"[phase 5b] rollback depth {depth}: {summary['rollbacks']} "
              f"rollbacks, {len(cids)} of {len(cids)} npz byte-equal to the "
              f"clean run; launches a chunk {rb_pc} (clean {clean_pc})")
    boom = WORK / "boom.jsonl"
    # a sigma-9 request in chaos-2's bucket group, beside chaos-2
    boom.write_text(json.dumps(dict(creqs[2], id="boom", sigma=9.0,
                                    ic="hat")) + "\n"
                    + json.dumps(creqs[2]) + "\n")
    rc, recs, summary, launches, _ = cli_serve(boom, WORK / "chaos-boom",
                                               "--serve-on-nan", "rollback")
    rb = {r["id"]: r for r in recs}
    check(rc == 1 and rb["boom"]["status"] == "nonfinite"
          and "after 2 rollbacks (deterministic blow-up)" in rb["boom"]["error"]
          and summary["rollbacks"] == 2 and summary["lanes_quarantined"] == 1,
          f"sigma-9 request: {rb['boom']}")
    check(rb[creqs[2]["id"]]["status"] == "ok"
          and not npz_differ([creqs[2]["id"]], WORK / "chaos-clean",
                             WORK / "chaos-boom"),
          "the sigma-9 request's lane-mate differs from the clean run")
    launches_are_the_chunks("sigma-9", launches, summary)
    print(f"[phase 5b] sigma-9 request quarantined after "
          f"{summary['rollbacks']} rollbacks; its lane-mate byte-equal")

    # --- perturb under --numerics-guard quarantine
    rc, rows, summary, launches, _ = cli_serve_rows(
        chaos, WORK / "chaos-perturb", "--numerics-guard", "quarantine",
        "--inject", "perturb@64:req=chaos-2")
    recs = {r["id"]: r for r in rows if r.get("event") == "serve_request"}
    bad = recs["chaos-2"]
    check(rc == 1 and bad["status"] == "nonfinite"
          and bad["error"].startswith("numerics: max-principle violation"),
          f"perturbed request: {bad}")
    others = [i for i in cids if i != "chaos-2"]
    check(all(recs[i]["status"] == "ok" for i in others)
          and not npz_differ(others, WORK / "chaos-clean",
                             WORK / "chaos-perturb"),
          "a request beside the perturbed one differs from the clean run")
    print(f"[phase 5b] perturb: chaos-2 quarantined ({bad['error'][:60]}...),"
          f" the other {len(others)} byte-equal to the clean run")

    # --- online growth: one request, then a burst of 7, through start()
    grow = [dict(n=250, ntime=20000, ic="hat", bc="ghost")] + [
        dict(n=100 + 20 * i, ntime=300 + 50 * i, ic=ICS[i % 4], bc="ghost")
        for i in range(7)]
    scfg = ServeConfig(lanes=8, chunk=16, buckets=(256, 512, 1024),
                       emit_records=False, keep_fields=True)
    eng = Engine(scfg, device="cuda")
    t0 = time.perf_counter()
    eng.start()
    try:
        gids = [eng.submit(HeatConfig(**grow[0]), request_id="grow-0")]
        t_wait = time.perf_counter()
        while (eng.poll("grow-0")["status"] == "queued"
               and time.perf_counter() - t_wait < 120):
            time.sleep(0.001)
        gids += [eng.submit(HeatConfig(**g), request_id=f"grow-{i + 1}")
                 for i, g in enumerate(grow[1:])]
        grecs = [eng.wait(i, timeout=300) for i in gids]
    finally:
        check(eng.shutdown(timeout=300), "online engine did not drain")
    gwall = time.perf_counter() - t0
    check(eng.loop_error is None and all(r and r["status"] == "ok"
                                         for r in grecs),
          f"online run: {eng.loop_error}, {[r and r['status'] for r in grecs]}")
    off = Engine(scfg, device="cuda")
    for i, g in zip(gids, grow):
        off.submit(HeatConfig(**g), request_id=i)
    orecs = {r["id"]: r for r in off.results()}
    same = all(eng._by_id[i]["T"].tobytes() == orecs[i]["T"].tobytes()
               for i in gids)
    print(f"[phase 5b] online: {len(gids)} requests through start() in "
          f"{gwall:.3f} s, lane_grows {eng.lane_grows}, fields byte-equal "
          f"to the offline run: {same}")
    check(eng.lane_grows >= 1, "the online engine never grew its lane tier")
    check(same, "online fields differ from the offline run()")
    out["online"] = dict(lane_grows=eng.lane_grows, wall_s=gwall)

    # --- fetch-hang trips the watchdog
    rc, recs, summary, _, hwall = cli_serve(
        chaos, WORK / "chaos-hang", "--fetch-watchdog", "2", "--inject",
        "fetch-hang@3:ms=10000")
    errs = [r for r in recs if r["status"] == "error"]
    check(rc == 1 and summary["watchdog_fired"] == 1 and errs
          and all("fetch-watchdog" in r["error"] for r in errs)
          and all(r["status"] in ("ok", "error") for r in recs),
          f"fetch-hang: rc {rc}, watchdog {summary['watchdog_fired']}, "
          f"{[(r['id'], r['status']) for r in recs]}")
    check(hwall < 10.0, f"fetch-hang serve took {hwall:.3f} s: it waited "
                        f"for the hang")
    print(f"[phase 5b] fetch-hang: watchdog fired after 2 s, {len(errs)} "
          f"request(s) of the hung group failed cleanly, serve exited rc "
          f"{rc} in {hwall:.3f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 5b] done in {out['phase_s']:.1f} s")
    return out


# --- phase 5c: the serving front -------------------------------------------

# the keys of a record that depend on wall time or on the order requests
# arrive in (an online stream admits them one by one, so lanes and chunk
# counts follow the arrivals), left out of the record comparison
FRONT_VARYING = ("queue_wait_s", "solve_s", "steps_per_s", "trace_id",
                 "path", "lane", "usage")
USAGE_EXACT = ("steps", "bytes_written", "steps_saved", "cached")


class Server:
    """``python -m heat_tpu_torch serve --listen 127.0.0.1:0`` at phase 5's
    arguments in a process of its own; a thread drains its output, so the
    pipe never fills. Every call goes through ``call`` with a timeout, and
    every status it answers is kept (a 5xx fails the phase)."""

    def __init__(self, *args, wait: bool = True):
        """Start the process; unless ``wait`` is False, wait until it
        listens (``ready``)."""
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "serve", "--listen",
             "127.0.0.1:0", *SERVE_ARGS, "--json", *args],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines, self.statuses = [], []
        self.listening = threading.Event()

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                if "gateway listening on http://" in line:
                    self.listening.set()
            self.listening.set()

        self.reader = threading.Thread(target=drain, daemon=True)
        self.reader.start()
        if wait:
            self.ready()

    def ready(self) -> None:
        """Wait (up to 180 s) until the gateway listens; sets ``base``, its
        address."""
        self.listening.wait(180)
        addr = next((x.split("http://")[1].split()[0] for x in self.lines
                     if "gateway listening on http://" in x), None)
        if addr is None:
            self.stop()
            check(False, "the gateway did not come up: "
                         + "\n".join(self.lines[-20:]))
        self.base = f"http://{addr}"

    def call(self, path, data=None, timeout=600):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.base}{path}", data=data,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                st, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            st, body = e.code, e.read().decode()
        self.statuses.append((path, st))
        check(st < 500, f"{path} answered {st}: {body[:500]}")
        return st, body

    def metrics(self) -> dict:
        _, text = self.call("/metrics")
        out = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
        return out

    def wait(self, timeout=600) -> int:
        try:
            rc = self.proc.wait(timeout)
        finally:
            self.stop()
        self.reader.join(30)
        return rc

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)

    def records(self) -> list:
        return [json.loads(x) for x in self.lines
                if x.startswith('{"') and '"serve_request"' in x]


def ndjson(body: str) -> list:
    return [json.loads(x) for x in body.splitlines() if x.strip()]


def sha256(path: Path) -> str:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest()


def records_agree(what, got: list, want: dict):
    """Each record of ``got`` equal to ``want``'s of the same id on every key
    but FRONT_VARYING, and on the exact usage keys."""
    for r in got:
        w = want[r["id"]]
        for k in set(r) | set(w):
            if k in FRONT_VARYING or k == "event":
                continue
            check(r.get(k) == w.get(k),
                  f"{what}: {r['id']} {k} {r.get(k)!r} != {w.get(k)!r}")
        for k in USAGE_EXACT:
            check(r["usage"][k] == w["usage"][k],
                  f"{what}: {r['id']} usage {k} {r['usage'][k]} != "
                  f"{w['usage'][k]}")


def in_process_serve(*argv):
    """``cli.main(["serve", *argv, "--json", *SERVE_ARGS])`` in this
    process with its output captured; returns (rc, rows, summary)."""
    from heat_tpu_torch import cli
    from heat_tpu_torch.runtime import faults

    faults.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", *argv, "--json", *SERVE_ARGS])
    lines = buf.getvalue().splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    print("".join(f"    | {x}\n" for x in lines if not x.startswith("{")),
          end="")
    return rc, rows, rows[-1]


def trace_split(path: Path, busy_s):
    """The host's time per chunk of one traced serve, from its trace file:
    the engine's wall (the ``engine.run`` span), the chunks, and the
    scheduler thread's boundary-fetch spans, the dispatch rows' device-idle
    spans and the writer's jobs."""
    chrome = json.loads(path.read_text())
    evs = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]

    def total(pred):
        sel = [e["dur"] for e in evs if pred(e)]
        return sum(sel) / 1e6, len(sel)

    wall, _ = total(lambda e: e["name"] == "engine.run")
    fetch, nfetch = total(lambda e: e["name"] == "boundary-fetch")
    idle, nidle = total(lambda e: e["name"] == "device-idle")
    writer, nwrite = total(lambda e: e.get("cat") == "io")
    chunks = sum(1 for e in evs if e.get("cat") == "chunk")
    host = wall - fetch
    split = dict(wall_s=wall, chunks=chunks, fetch_s=fetch, fetches=nfetch,
                 idle_s=idle, idle_spans=nidle, writer_s=writer,
                 writer_jobs=nwrite, host_s=host,
                 ms_per_chunk=1e3 * wall / chunks,
                 fetch_ms_per_chunk=1e3 * fetch / chunks,
                 host_ms_per_chunk=1e3 * host / chunks,
                 busy_share=(busy_s / wall if busy_s else None))
    print(f"  trace split: {chunks} chunks in {wall:.3f} s of engine wall, "
          f"{split['ms_per_chunk']:.4f} ms a chunk: boundary fetch "
          f"{fetch:.3f} s ({split['fetch_ms_per_chunk']:.4f} ms a chunk, "
          f"{nfetch} fetches), the scheduler's own host work "
          f"{host:.3f} s ({split['host_ms_per_chunk']:.4f} ms a chunk: "
          f"dispatch, judging, fills, numerics, records); device-idle gaps "
          f"{idle:.3f} s in {nidle} spans; writer jobs {writer:.3f} s in "
          f"{nwrite} (their own thread)"
          + (f"; card busy {busy_s / wall:.1%} of the engine wall (phase "
             f"5's profiled device seconds)" if busy_s else ""))
    return split


def front_faults(serve, body: str, cache: Path, ref_dir: Path, ck2: Path,
                 path: Path, gen: int) -> None:
    """Phase 5c's fault cases (byte checks, nothing timed): the handoff
    manifest of ``gen`` corrupted in the copy ``ck2`` and resumed in this
    process (the fallback to generation ``gen - 1``); ``cache-corrupt``
    and ``cache-stale`` on two of phase 5's requests, each from a cache
    holding its entry alone."""
    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.runtime import checkpoint as ckpt
    from heat_tpu_torch.runtime import faults

    # the ckpt-manifest-corrupt fault on the copy's handoff manifest: the
    # resume quarantines it and falls back one generation
    faults.FaultPlan(f"ckpt-manifest-corrupt@{gen}").damage_manifest(
        ck2 / path.name, gen)
    prev = json.loads((ck2 / f"engine_gen{gen - 1:08d}.json").read_text())
    o4 = WORK / "front-out-fallback"
    rc, rows, summ = in_process_serve("--resume", str(ck2), "--out-dir",
                                      str(o4))
    recs4 = [r for r in rows if r.get("event") == "serve_request"]
    want4 = sorted(e["id"] for e in prev["inflight"] + prev["queued"])
    check(rc == 0 and (ck2 / f"{path.name}.corrupt").exists()
          and sorted(r["id"] for r in recs4) == want4,
          f"the fallback resume (rc {rc})")
    ndiff = npz_differ(want4, o4, ref_dir)
    check(not ndiff, f"fallback resume npz differ: {ndiff}")
    print(f"  ckpt-manifest-corrupt@{gen}: generation {gen} quarantined, "
          f"the resume fell back to generation {gen - 1} and finished its "
          f"{len(want4)} requests byte-equal to phase 5's")
    # the cache faults on two of phase 5's requests, each in a cache dir
    # that holds its full entry alone (the gateway's dir also holds the
    # checkpoints' prefix entries): quarantined, recomputed byte-equal
    small = sorted((r for r in serve["records"] if r["ndim"] == 2
                    and r["dtype"] == "float32"),
                   key=lambda r: r["n"] ** 2 * r["ntime"])[:2]
    src = {json.loads(x)["id"]: json.loads(x) for x in body.splitlines()}
    for kind, r in zip(("cache-corrupt", "cache-stale"), small):
        req = src[r["id"]]
        fp = ckpt.config_fingerprint(HeatConfig(**{
            k: v for k, v in req.items() if k != "id"}))
        one_cache = WORK / f"front-cache-{kind}"
        one_cache.mkdir()
        for f in cache.glob(f"{fp}-{req['ntime']:08d}.*"):
            shutil.copy(f, one_cache / f.name)
        check(len(list(one_cache.iterdir())) == 2, f"{kind}: no entry")
        one = WORK / f"front-{kind}.jsonl"
        one.write_text(json.dumps(dict(req, id=f"{r['id']}-{kind}")) + "\n")
        o5 = WORK / f"front-out-{kind}"
        rc, rows, summ = in_process_serve(
            "--requests", str(one), "--out-dir", str(o5), "--cache", "on",
            "--cache-dir", str(one_cache), "--inject", kind)
        (rec,) = [x for x in rows if x.get("event") == "serve_request"]
        check(rc == 0 and rec["status"] == "ok" and not rec["cached"]
              and summ["cache"]["quarantined"] == 1,
              f"{kind}: the entry was not quarantined and recomputed")
        check((o5 / f"{rec['id']}.npz").read_bytes()
              == (ref_dir / f"{r['id']}.npz").read_bytes(),
              f"{kind}: the recomputed npz differs from phase 5's")
        print(f"  {kind}: entry quarantined, {r['id']} recomputed "
              f"byte-equal")


def phase_serving_front(smi, serve):
    """Phase 5c: the serving front on the card (see the module docstring):
    ``serve --listen`` with the cache, engine checkpoints and the prober;
    the repeat from the cache; the handoff drain and ``serve --resume``;
    the observatories' cost; the trace's split of a chunk's host time;
    ``run --trace``."""
    from heat_tpu_torch.runtime import checkpoint as ckpt

    t_phase = time.perf_counter()
    reqfile = WORK / "requests.jsonl"
    body = reqfile.read_text()
    ids = [json.loads(x)["id"] for x in body.splitlines()]
    ref_dir = WORK / "serve-cuda"
    offline = {r["id"]: r for r in serve["records"]}
    busy_s = (serve["profile"] or {}).get("busy_s")
    out = {}

    # 1. the gateway: the 56 requests as one NDJSON stream
    o1, cache = WORK / "front-out", WORK / "front-cache"
    print(f"[phase 5c] serve --listen {' '.join(SERVE_ARGS)} --cache on "
          f"--engine-ckpt-interval 64 --probe-interval 1")
    srv = Server("--out-dir", str(o1), "--cache", "on", "--cache-dir",
                 str(cache), "--engine-ckpt-interval", "64",
                 "--probe-interval", "1", wait=False)
    # (3)'s server, started beside this one and idle until (3): the two
    # start-ups overlap, and both listen before anything is timed
    ck, o3 = WORK / "front-ckpt", WORK / "front-out-handoff"
    nxt = Server("--out-dir", str(o3), "--engine-ckpt-interval", "64",
                 "--engine-ckpt-dir", str(ck), wait=False)
    try:
        srv.ready()
        nxt.ready()
        t0 = time.perf_counter()
        st, text = srv.call("/v1/solve", body.encode())
        wall1 = time.perf_counter() - t0
        check(st == 200, f"/v1/solve answered {st}")
        recs = ndjson(text)
        check(sorted(r["id"] for r in recs) == sorted(ids)
              and all(r["status"] == "ok" for r in recs),
              "not every streamed record ok")
        records_agree("gateway", recs, offline)
        ndiff = npz_differ(ids, o1, ref_dir)
        check(not ndiff, f"gateway npz differ from phase 5's: {ndiff}")
        m = srv.metrics()
        _, usage = srv.call("/v1/usage")
        usage = json.loads(usage)["tenants"]["default"]
        for k in ("steps", "chunks", "bytes_written"):
            want = sum(int(r["usage"][k]) for r in recs)
            got_m = m[f'heat_tpu_usage_{k}_total{{tenant="default",'
                      f'class="standard"}}']
            check(usage[k] == want and got_m == want,
                  f"usage {k}: /v1/usage {usage[k]}, /metrics {got_m}, "
                  f"records {want}")
        check(m['heat_tpu_usage_requests_total{tenant="default",'
                'class="standard"}'] == len(ids), "usage requests")
        check(m['heat_tpu_serve_requests_total{status="ok"}'] >= len(ids),
              "/metrics ok requests")
        _, tz = srv.call("/tracez")
        chrome = json.loads(tz)
        check(isinstance(chrome.get("traceEvents"), list)
              and chrome["traceEvents"], "/tracez is no Chrome trace")
        st, statusz = srv.call("/statusz")
        check(st == 200 and statusz.startswith("heat_tpu_torch serving"),
              "/statusz")
        mem = {k: v for k, v in m.items()
               if k.startswith("heat_tpu_mem_bytes_in_use")}
        check(list(mem) == ['heat_tpu_mem_bytes_in_use{source="device"}']
              and list(mem.values())[0] > 0,
              f"memory watermark not from the device: {mem}")
        gens = m["heat_tpu_engine_ckpt_generation"]
        chunks1 = m["heat_tpu_serve_chunks_dispatched_total"]
        print(f"  {len(recs)} streamed records ok, npz byte-equal to phase "
              f"5's, in "
              f"{wall1:.3f} s of wall (phase 5 offline {serve['wall_s']:.3f}"
              f" s); usage steps {usage['steps']}, chunks "
              f"{usage['chunks']}, bytes {usage['bytes_written']} reconcile "
              f"with the records; device memory "
              f"{list(mem.values())[0] / 2**20:.1f} MiB in use; "
              f"{int(gens)} engine checkpoint generation(s); "
              f"{len(chrome['traceEvents'])} events on /tracez")

        # 2. the same file again: every request a full cache hit
        again = "".join(json.dumps(dict(json.loads(x), id=json.loads(x)["id"]
                                        + "-again")) + "\n"
                        for x in body.splitlines())
        t0 = time.perf_counter()
        st, text = srv.call("/v1/solve", again.encode())
        wall2 = time.perf_counter() - t0
        recs2 = ndjson(text)
        check(st == 200 and len(recs2) == len(ids)
              and all(r["status"] == "ok" and r["cached"] for r in recs2),
              "the repeat was not all full cache hits")
        same = [i for i in ids
                if sha256(o1 / f"{i}-again.npz") == sha256(o1 / f"{i}.npz")]
        check(len(same) == len(ids), "cache replays differ in sha256")
        m2 = srv.metrics()
        check(m2["heat_tpu_serve_chunks_dispatched_total"] == chunks1,
              f"the repeat dispatched chunks: {chunks1} -> "
              f"{m2['heat_tpu_serve_chunks_dispatched_total']}")
        hits = m2['heat_tpu_cache_hits_total{kind="full"}']
        deadline = time.perf_counter() + 60
        while m2['heat_tpu_probe_runs_total{result="pass"}'] < 1:
            check(time.perf_counter() < deadline, "no probe within 60 s")
            time.sleep(0.2)
            m2 = srv.metrics()
        passed = m2['heat_tpu_probe_runs_total{result="pass"}']
        check(m2['heat_tpu_probe_runs_total{result="fail"}'] == 0
              and passed >= 1, "a probe failed")
        print(f"  the repeat: {len(recs2)} full cache hits (sha256 equal, no "
              f"chunk dispatched, so no lane launch) in {wall2:.3f} s; "
              f"{int(hits)} full hits in all (probes included); probes "
              f"{int(passed)} pass / 0 fail")
        srv.call("/drainz", b"")
        rc = srv.wait()
    except BaseException:
        nxt.stop()
        raise
    finally:
        srv.stop()
    summary = json.loads(srv.lines[-1])
    check(rc == 0, f"the gateway exited {rc}: " + "\n".join(srv.lines[-10:]))
    check(summary["probe_fail"] == 0 and summary["probe_pass"] >= 1,
          "probes in the final summary")
    check(not [s for s in srv.statuses if s[1] >= 500], "a 5xx answered")
    out.update(gateway_wall_s=wall1, repeat_wall_s=wall2,
               probes=summary["probe_pass"], cache_hits=len(recs2),
               generations=int(gens))

    # 3. handoff: a fresh server, the cache off; /drainz?handoff=1 once its
    # first engine checkpoint is published, then serve --resume elsewhere
    print("[phase 5c] handoff: serve --listen --engine-ckpt-interval 64, "
          "/drainz?handoff=1 after the first generation, then serve "
          "--resume in a new process")
    srv = nxt
    try:
        st, _ = srv.call("/v1/solve?wait=0", body.encode())
        check(st == 202, f"/v1/solve?wait=0 answered {st}")
        deadline = time.perf_counter() + 300
        while srv.metrics()["heat_tpu_engine_ckpt_generation"] < 1:
            check(time.perf_counter() < deadline and srv.proc.poll() is None,
                  "no engine checkpoint within 300 s")
            time.sleep(0.02)
        st, text = srv.call("/drainz?handoff=1", b"")
        check(st == 200 and json.loads(text)["handoff"], "handoff refused")
        srv.wait()
    finally:
        srv.stop()
    handoff_recs = srv.records()
    man, path = ckpt.latest_engine_manifest(ck)
    check(man is not None and man["reason"] == "handoff",
          f"no handoff generation in {ck}")
    inflight = [e["id"] for e in man["inflight"]]
    gen = int(man["generation"])
    check(inflight and gen >= 2, f"handoff generation {gen} holds "
                                 f"{len(inflight)} lanes")
    done_before = {r["id"] for r in handoff_recs if r["status"] == "ok"}
    check(done_before == set(man["done"]),
          "the manifest's done set is not the records'")
    ck2 = WORK / "front-ckpt-corrupt"
    shutil.copytree(ck, ck2)
    # the resume in a child process, beside the fallback and the cache
    # faults below (byte checks all, nothing timed)
    resume_log = WORK / "front-resume.log"
    with open(resume_log, "w") as log:
        resume = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "serve", "--resume",
             str(ck), "--out-dir", str(o3), "--json", *SERVE_ARGS],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=log, stderr=subprocess.STDOUT)
    try:
        front_faults(serve, body, cache, ref_dir, ck2, path, gen)
        rc = resume.wait(timeout=600)
    finally:
        if resume.poll() is None:
            resume.kill()
            resume.wait()
    text = resume_log.read_text()
    check(rc == 0, f"serve --resume exited {rc}: {text[-4000:]}")
    resumed = [json.loads(x) for x in text.splitlines()
               if x.startswith('{"') and '"serve_request"' in x]
    check(sorted(r["id"] for r in resumed) == sorted(set(ids) - done_before)
          and all(r["status"] == "ok" and r["resumed"] for r in resumed),
          "the resumed records")
    ndiff = npz_differ(ids, o3, ref_dir)
    check(not ndiff, f"handoff + resume npz differ from phase 5's: {ndiff}")
    print(f"  handoff at generation {gen}: {len(inflight)} lanes in flight, "
          f"{len(man['queued'])} queued, {len(man['done'])} done; the "
          f"resume (a child beside the fault cases above) finished "
          f"{len(resumed)} (every in-flight record resumed), all {len(ids)} "
          f"npz byte-equal to phase 5's")

    # 4. the observatories' cost: phase 5's file with the reference's
    # defaults (--prof on, the ring on) and with both off, in turns
    walls = {"on": [], "off": []}
    waits = set()
    for i in range(2):
        for mode in (("on", "off") if i == 0 else ("off", "on")):
            extra = () if mode == "on" else ("--prof", "off",
                                             "--trace-buffer", "0")
            rc, recs_ab, summ, _, wall = cli_serve(
                reqfile, WORK / f"serve-obs-{mode}-{i}", *extra)
            check(rc == 0 and all(r["status"] == "ok" for r in recs_ab),
                  f"observatories {mode} serve failed")
            check(not npz_differ(ids, WORK / f"serve-obs-{mode}-{i}",
                                 ref_dir),
                  f"observatories {mode} npz differ from phase 5's")
            check(summ["prof"] is (mode == "on"), "--prof did not take")
            waits.add(summ["boundary_waits"])
            walls[mode].append(wall)
            print(f"  observatories {mode}: {wall:.3f} s of wall, "
                  f"{summ['boundary_waits']} boundaries"
                  + (f", card busy {busy_s / wall:.1%} (phase 5's "
                     f"profiled device seconds over this wall)"
                     if busy_s else ""))
    check(len(waits) == 1, f"boundary fetches differ on/off: {waits}")
    out["obs_walls"] = walls

    # 5. where a chunk's host time goes: one traced run of phase 5's file
    tpath = WORK / "serve.trace.json"
    rc, recs_t, summ, _, wall = cli_serve(
        reqfile, WORK / "serve-traced", "--trace", str(tpath),
        "--trace-buffer", "400000")
    check(rc == 0 and tpath.exists(), "the traced serve")
    check(not npz_differ(ids, WORK / "serve-traced", ref_dir),
          "the traced serve's npz differ from phase 5's")
    from heat_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(["trace", str(tpath)]) == 0, "trace subcommand")
    print("".join(f"    | {x}\n" for x in buf.getvalue().splitlines()),
          end="")
    split = trace_split(tpath, busy_s)
    check(split["chunks"] == summ["chunks_dispatched"],
          f"{split['chunks']} chunk spans != {summ['chunks_dispatched']} "
          f"chunks dispatched")
    out["split"] = split

    # 6. run --trace: the chunk spans are the run's launch groups
    tr = WORK / "run.trace.json"
    ntime = 320
    # a heartbeat every 16 steps makes each chunk one 16-step call: one
    # launch group, one span
    text, launches = cli_run(f"4096 0.25 0.05 2.0 {ntime} 0\n", "--dtype",
                             "float32", "--heartbeat-every", "16", "--json",
                             "--trace", str(tr))
    evs = json.loads(tr.read_text())["traceEvents"]
    spans = [e for e in evs if e.get("name", "").startswith("chunk @")]
    timed, warm = expected_launches((4096, 4096), "float32", ntime)
    (compile_span,) = [e for e in evs if e.get("name") == "compile"]
    check(len(spans) == ntime // 16 and len(spans) == timed
          and launches["ftcs2d"] == timed + warm,
          f"run --trace: {len(spans)} chunk spans, {launches} launches "
          f"(timed {timed} + warm-up {warm})")
    print(f"[phase 5c] run --trace 4096^2 f32 x {ntime}: {len(spans)} chunk "
          f"spans = {timed} timed launches of ftcs2d (+ {warm} in the "
          f"compile span, sizes {compile_span['args']['sizes']}); "
          f"{len(evs)} events")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 5c] {out['phase_s']:.1f} s on {smi}")
    return out


# --- phase 5d: mega-lanes ---------------------------------------------------

# the oversized requests: the python/cuda shape as phase 3 runs it and a
# bf16 cut of it; config 4 (512^3 at sigma 1/6) as phase 3 runs it;
# hip.dat (32768^2, ghost, ntime cut to 128) as phase 7 runs it; the
# fault cases' 4096^2 f32 x 512
MEGA_F32 = dict(id="mega-f32", n=4096, ntime=8192, sigma=0.25, nu=0.05,
                dom_len=2.0, dtype="float32", bc="edges", ic="hat")
MEGA_BF16 = dict(MEGA_F32, id="mega-bf16", ntime=256, dtype="bfloat16")
MEGA_3D = dict(id="mega-512", n=512, ndim=3, ntime=3200, sigma=SIGMA_3D,
               nu=0.05, dom_len=2.0, dtype="float32")
MEGA_HIP = dict(id="mega-hip", n=32768, ntime=128, dtype="float32",
                sigma=0.25, nu=0.05, dom_len=1.0, ic="uniform", bc="ghost")
MEGA_FAULT = dict(MEGA_F32, id="mega-fault", ntime=512)


def mega_config(r):
    from heat_tpu_torch import HeatConfig

    return HeatConfig(**{k: v for k, v in r.items() if k != "id"})


def mega_launches(cfg, mesh, chunk: int) -> tuple:
    """(launches, kf, padded shard shape, launches a chunk by chunk size)
    of one mega request: every chunk of k steps runs, on each shard,
    divmod(k - 1, kf) blocks of kf steps, the remainder block and the final
    step, each cut into the reference's passes at the padded shard
    shape."""
    import math

    from heat_tpu_torch.backends import sharded
    from heat_tpu_torch.ops import pass_schedule

    kf = sharded.fuse_depth_sharded(cfg, mesh)
    padded = tuple(cfg.n // m + 2 * kf for m in mesh)

    def npass(k):
        return len(pass_schedule.passes(padded, cfg.dtype, k)) if k else 0

    per = {}
    for k in {min(chunk, cfg.ntime), cfg.ntime % chunk} - {0}:
        nf, r = divmod(k - 1, kf)
        per[k] = math.prod(mesh) * (nf * npass(kf) + npass(r) + npass(1))
    total = (cfg.ntime // chunk) * per.get(chunk, 0) + per.get(
        cfg.ntime % chunk, 0)
    return total, kf, padded, per


def mega_serve(reqs, **kw):
    """Drain ``reqs`` through an in-process ``Engine`` on the card with
    one mega slot, the fields kept in memory; the stencil launch counts
    zeroed just before and read just after. Returns (engine, records by
    id, wall seconds, launches)."""
    from heat_tpu_torch.ops import cuda_stencil as cs
    from heat_tpu_torch.runtime import faults
    from heat_tpu_torch.serve import Engine, ServeConfig

    faults.reset()
    knobs = dict(lanes=8, chunk=16, buckets=(256, 512, 1024),
                 emit_records=False, keep_fields=True, mega_lanes=1)
    eng = Engine(ServeConfig(**dict(knobs, **kw)), device="cuda")
    for r in reqs:
        eng.submit(mega_config(r), request_id=r["id"])
    cs.reset_launches()
    t0 = time.perf_counter()
    recs = {r["id"]: r for r in eng.results()}
    wall = time.perf_counter() - t0
    return eng, recs, wall, dict(cs.launches)


def host_bits(T):
    """The bytes of a host field (a ``V2`` bf16 array or a float one)."""
    import numpy as np

    return np.ascontiguousarray(T).view(np.uint8)


def mega_busy(fn):
    """Device seconds of ``fn()``'s kernels under ``torch.profiler``, in all
    and for ftcs2d/ftcs3d, beside ``wall_s``, what ``fn`` returns (the
    profiled run's own wall, or None); None where the profiler records
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  device busy: not measured ({type(e).__name__}: {e})")
        return None

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))

    dev = [(dev_us(e), e.key) for e in rows
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(t for t, _ in dev) / 1e6
    if busy <= 0:
        return None
    ftcs = sum(t for t, key in dev if re.search(r"ftcs|stream", key)) / 1e6
    return dict(busy_s=busy, kernel_s=ftcs, other_s=busy - ftcs,
                wall_s=wall)


def phase_mega(smi, serve, runs):
    """Phase 5d, mega-lanes: a bucket-overflow request served over every
    shard of the mesh through the sharded padded carry (see the module
    docstring). Returns the numbers and the digest of the 32768^2 field,
    which phase 7 holds against its 2x2 sharded run."""
    import functools
    import hashlib
    import threading
    from unittest import mock

    import numpy as np
    import torch

    from heat_tpu_torch import solve
    from heat_tpu_torch.backends import sharded
    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_stencil as cs
    from heat_tpu_torch.ops import pass_schedule
    from heat_tpu_torch.runtime import checkpoint as ckpt
    from heat_tpu_torch.serve import Engine, ServeConfig
    from heat_tpu_torch.serve import scheduler as sch
    from heat_tpu_torch.serve.engine import MegaLaneEngine, fetch_boundary
    from heat_tpu_torch.utils import torch_dtype

    t0 = time.perf_counter()
    out = {"requests": {}, "kernels": {}}
    plain = functools.partial(cs.ftcs_multistep_bounded_cuda, plain=True)

    def cell_steps(r):
        return r["n"] ** r.get("ndim", 2) * r["ntime"]

    # 1. phase 5's 56 requests with the two oversized ones, one mega slot
    reqfile = WORK / "requests-mega.jsonl"
    reqs = serve_population(WORK / "requests-mega-packed.jsonl")
    reqfile.write_text("".join(json.dumps(r) + "\n"
                               for r in reqs + [MEGA_F32, MEGA_BF16]))
    out_m = WORK / "serve-mega"
    print(f"[phase 5d] serve --mega-lanes 1: phase 5's {len(reqs)} requests "
          f"and 4096^2 f32 x 8192, 4096^2 bf16 x 256")
    cs.reset_launches()
    rc, rows, summary, lane_launches, wall = cli_serve_rows(
        reqfile, out_m, "--mega-lanes", "1")
    ftcs = dict(cs.launches)
    out["corun_launches"] = ftcs
    recs = {r["id"]: r for r in rows if r.get("event") == "serve_request"}
    check(rc == 0 and len(recs) == len(reqs) + 2
          and all(r["status"] == "ok" for r in recs.values()),
          f"the co-scheduled serve failed (rc {rc})")
    for r in (MEGA_F32, MEGA_BF16):
        rec = recs[r["id"]]
        check(rec["placement"] == "mega" and rec["bucket"] is None,
              f"{r['id']} placed {rec['placement']} bucket {rec['bucket']}")
    check(summary["placement"] == {"mega": 2, "packed": len(reqs)},
          f"placement {summary['placement']}")
    check(summary["mega_compiles"] >= 1 and summary["mega_lanes"] == 1,
          f"mega_compiles {summary['mega_compiles']}")
    ids = [r["id"] for r in reqs]
    ndiff = npz_differ(ids, out_m, WORK / "serve-cuda")
    check(not ndiff, f"packed npz beside the mega-lanes differ from phase "
                     f"5's: {ndiff}")
    packed_rate = sum(cell_steps(r) for r in reqs) / wall
    want = sum(mega_launches(mega_config(r), (1, 1), 16)[0]
               for r in (MEGA_F32, MEGA_BF16))
    check(ftcs["ftcs2d"] == want, f"{ftcs['ftcs2d']} ftcs2d launches, the "
                                  f"mega chunks' passes are {want}")
    print(f"  {len(recs)} records ok, placement {summary['placement']}, "
          f"{summary['mega_compiles']} mega machinery build(s), "
          f"{summary['mega_chunks']} mega chunks, {ftcs['ftcs2d']} ftcs2d "
          f"launches (= the passes of the mega chunks), lane launches "
          f"{lane_launches}; {len(ids)} packed npz byte-equal to phase 5's; "
          f"packed tier {packed_rate:.6g} cell-steps/s with the mega-lanes "
          f"resident in {wall:.3f} s (phase 5 alone "
          f"{serve['cell_steps_per_s']:.6g}) on {smi}")
    out["packed_rate"] = packed_rate
    out["corun_wall_s"] = wall

    def npz_field(rid):
        with np.load(out_m / f"{rid}.npz") as z:
            return z["T"]

    # 2. the f32 mega-lane against run --backend cuda and --backend sharded
    cfg = mega_config(MEGA_F32)
    Tm = npz_field("mega-f32")
    for backend in ("cuda", "sharded"):
        with contextlib.redirect_stdout(io.StringIO()):
            T = solve(cfg.with_(backend=backend), device="cuda").T
        same = np.array_equal(host_bits(T), host_bits(Tm))
        print(f"  4096^2 f32 x 8192 mega npz vs run --backend {backend}: "
              f"byte-equal {same}")
        check(same, f"the f32 mega-lane is not the {backend} run's field")
        del T
    # 3. the bf16 mega-lane against the same machinery on the plain
    # bounded version, on the card
    with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda", plain):
        _, prec, _, pl = mega_serve([MEGA_BF16])
    check(pl["ftcs2d"] == 0, "the plain mega run launched ftcs2d")
    same = np.array_equal(host_bits(prec["mega-bf16"]["T"]),
                          host_bits(npz_field("mega-bf16")))
    print(f"  4096^2 bf16 x 256 mega npz vs the plain local kernel on the "
          f"card: byte-equal {same}")
    check(same, "the bf16 mega-lane is not its plain local kernel's")

    # 4. the same oversized request without --mega-lanes: auto is 0 on one
    # card, so it is rejected with the reference's reason and hint
    one = WORK / "requests-mega-one.jsonl"
    one.write_text(json.dumps(MEGA_F32) + "\n")
    rc, rows, _, _, _ = cli_serve_rows(one, WORK / "serve-mega-off",
                                       echo=False)
    (rec,) = [r for r in rows if r.get("event") == "serve_request"]
    check(rc == 1 and rec["status"] == "rejected"
          and rec.get("hint") == "enable --mega-lanes"
          and "auto enables mega-lanes only on multi-device hosts"
          in rec["error"], f"no auto rejection: {rec}")
    print(f"  without --mega-lanes: rc {rc}, {rec['status']}: "
          f"{rec['error']!r}, hint {rec['hint']!r}")

    # 5. each mega request alone: served cell-steps/s against its run twin,
    # chunks and launches a chunk against the pass schedule, the host per
    # chunk from a traced run, the card's busy share from a profiled run
    dm = device_model(0)
    twin = {"mega-f32": runs["4096 f32"]["points_per_s"],
            "mega-512": runs["512^3 f32"]["points_per_s"]}
    for r, buckets in ((MEGA_F32, (256, 512, 1024)), (MEGA_3D, (256,))):
        rid, cfg = r["id"], mega_config(r)
        name = cs._KERNELS[cfg.ndim]
        eng, recs1, wall1, l1 = mega_serve([r], buckets=buckets)
        rec = recs1[rid]
        check(rec["status"] == "ok" and rec["placement"] == "mega",
              f"{rid} {rec['status']}")
        total, kf, padded, per = mega_launches(cfg, (1,) * cfg.ndim, 16)
        check(l1[name] == total, f"{rid}: {l1[name]} {name} launches, "
                                 f"expected {total}")
        chunks = rec["usage"]["chunks"]
        with contextlib.redirect_stdout(io.StringIO()):
            T = solve(cfg.with_(backend="cuda"), device="cuda").T
        same = np.array_equal(host_bits(T), host_bits(rec["T"]))
        check(same, f"{rid} is not the run --backend cuda field")
        del T
        rate = cell_steps(r) / wall1
        trace = WORK / f"{rid}.trace.json"
        mega_serve([r], buckets=buckets, trace=str(trace))
        split = trace_split(trace, None)
        # the share of the profiled run's own drain wall
        busy = mega_busy(lambda: mega_serve([r], buckets=buckets)[2])
        share = None if busy is None else busy["busy_s"] / busy["wall_s"]
        out["requests"][rid] = dict(
            wall_s=wall1, cell_steps_per_s=rate, run_points_per_s=twin[rid],
            chunks=chunks, launches=l1[name], launches_per_chunk=per,
            kf=kf, padded=padded, host_ms_per_chunk=split["host_ms_per_chunk"],
            fetch_ms_per_chunk=split["fetch_ms_per_chunk"],
            busy=busy, busy_share=share)
        print(f"  {rid} ({cfg.n}^{cfg.ndim} {cfg.dtype} x {cfg.ntime}, "
              f"--buckets {','.join(map(str, buckets))}): {rate:.6g} served "
              f"cell-steps/s in {wall1:.3f} s against run --backend cuda "
              f"{twin[rid]:.6g} points/s ({rate / twin[rid]:.4f}x); field "
              f"byte-equal to the run; {chunks} chunks, {l1[name]} {name} "
              f"launches ({l1[name] / chunks:.4f} a chunk; the pass schedule "
              f"gives {per} by chunk size at {'x'.join(map(str, padded))}, "
              f"kf {kf}); host {split['host_ms_per_chunk']:.4f} ms + fetch "
              f"{split['fetch_ms_per_chunk']:.4f} ms a chunk; card busy "
              + ("not measured" if busy is None else
                 f"{busy['busy_s']:.6f} s = {share:.1%} of the profiled "
                 f"run's {busy['wall_s']:.3f} s of wall ("
                 f"{name} {busy['kernel_s']:.6f} s, other {busy['other_s']:.6f}"
                 f" s)") + f" on {smi}")
        del eng, recs1
        torch.cuda.empty_cache()

    # 6. hip.dat on 2x2 shards of the one card: the mega mesh through the
    # mega_device_count seam set to 4; the field's digest goes to phase 7
    with mock.patch.object(sch, "mega_device_count", lambda device: 4):
        eng, rh, wall_h, lh = mega_serve([MEGA_HIP], buckets=(256,))
    rec = rh["mega-hip"]
    check(rec["status"] == "ok" and rec["placement"] == "mega",
          f"hip.dat mega {rec['status']}: {rec.get('error')}")
    total, kf, padded, per = mega_launches(mega_config(MEGA_HIP), (2, 2), 16)
    check(lh["ftcs2d"] == total, f"hip.dat mega: {lh['ftcs2d']} ftcs2d "
                                 f"launches, expected {total}")
    digest = hashlib.sha256(host_bits(rec.pop("T"))).hexdigest()
    del eng, rh
    torch.cuda.empty_cache()
    # one 16-step chunk alone (CUDA events around dispatch and fetch), and
    # the device seconds of two chunks by kernel and the rest (exchanges,
    # the stats)
    eng = MegaLaneEngine(mega_config(MEGA_HIP), 4, 16, device="cuda",
                         cache={})

    def chunk():
        return fetch_boundary(eng.dispatch_chunk(16), timeout_s=600)

    def two_chunks():
        chunk()
        chunk()

    chunk_ms = event_ms(chunk, 2)
    hip_busy = mega_busy(two_chunks)
    del eng
    torch.cuda.empty_cache()
    rate = cell_steps(MEGA_HIP) / wall_h
    out["requests"]["mega-hip"] = dict(wall_s=wall_h, cell_steps_per_s=rate,
                                       chunks=rec["usage"]["chunks"],
                                       launches=lh["ftcs2d"], kf=kf,
                                       padded=padded, digest=digest,
                                       chunk_ms=chunk_ms, busy=hip_busy)
    print(f"  mega-hip (32768^2 f32 x 128 ghost, 2x2 shards on the one "
          f"card): {rate:.6g} served cell-steps/s in {wall_h:.3f} s (the "
          f"IC, 8 chunks, the crop and the 4 GiB copy to the host), "
          f"{rec['usage']['chunks']} chunks, {lh['ftcs2d']} ftcs2d launches "
          f"({per} a chunk) at {'x'.join(map(str, padded))} kf {kf}; one "
          f"chunk {chunk_ms:.4f} ms, "
          + ("device not measured" if hip_busy is None else
             f"device {hip_busy['busy_s'] / 2 * 1e3:.4f} ms a chunk (ftcs2d "
             f"{hip_busy['kernel_s'] / 2 * 1e3:.4f} ms, other "
             f"{hip_busy['other_s'] / 2 * 1e3:.4f} ms)")
          + f"; sha256 {digest[:16]} (held against phase 7's 2x2 run) on "
          f"{smi}")

    # 7. faults on 4096^2 f32 x 512: lane-nan healed by rollback; the
    # handoff drain with the mega occupant in flight, then serve --resume
    # in a new process
    cfg = mega_config(MEGA_FAULT)
    with contextlib.redirect_stdout(io.StringIO()):
        clean = solve(cfg.with_(backend="cuda"), device="cuda").T
    with contextlib.redirect_stdout(io.StringIO()):
        eng, rr, _, _ = mega_serve([MEGA_FAULT], on_nan="rollback",
                                   inject="lane-nan@100:req=mega-fault")
    rec = rr["mega-fault"]
    same = rec["status"] == "ok" and np.array_equal(host_bits(rec["T"]),
                                                    host_bits(clean))
    print(f"  lane-nan@100 under --serve-on-nan rollback: {rec['status']}, "
          f"{eng.rollbacks} rollback(s), byte-equal to the clean run {same}")
    check(same and eng.rollbacks == 1, "the mega rollback did not heal")
    ck = WORK / "mega-ckpt"
    held, asked = [], threading.Event()
    orig = sch.MegaLaneRunner.process_boundary

    def gated(self):
        orig(self)
        held.append(1)
        if len(held) == 4:
            asked.wait(120)

    with mock.patch.object(sch.MegaLaneRunner, "process_boundary", gated):
        eng = Engine(ServeConfig(lanes=8, chunk=16, mega_lanes=1,
                                 emit_records=False, engine_ckpt_dir=str(ck)),
                     device="cuda")
        eng.submit(cfg, request_id="mega-fault")
        eng.start()
        try:
            for _ in range(12000):
                if len(held) >= 4 or not eng.online:
                    break
                time.sleep(0.01)
            check(len(held) >= 4, "the handoff never reached its hold")
            eng.begin_drain(handoff=True)
        finally:
            asked.set()
            check(eng.shutdown(timeout=300), "the handoff drain hung")
    man, _ = ckpt.latest_engine_manifest(ck)
    (entry,) = man["inflight"]
    check(entry["placement"] == "mega" and 0 < entry["remaining"] < 512,
          f"handoff manifest {entry}")
    out_r = WORK / "serve-mega-resume"
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "serve", "--resume",
         str(ck), "--out-dir", str(out_r), "--mega-lanes", "1", "--json",
         *SERVE_ARGS], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=600)
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    (rec,) = [r for r in rows if r.get("event") == "serve_request"]
    with np.load(out_r / "mega-fault.npz") as z:
        same = np.array_equal(host_bits(z["T"]), host_bits(clean))
    print(f"  handoff with the mega occupant in flight ({entry['remaining']} "
          f"steps left at generation {man['generation']}), serve --resume in "
          f"a new process: rc {proc.returncode}, {rec['status']}, resumed "
          f"{rec['resumed']}, byte-equal to the clean run {same}")
    check(proc.returncode == 0 and rec["status"] == "ok" and rec["resumed"]
          and same, f"the mega resume failed: {proc.stderr[-2000:]}")
    del clean

    # 8. each mega block's kernel against its plain version, one chunk of
    # the 4096^2 and 512^3 mega shapes in f32 and bf16: boundary vector
    # and field bytes; the f32 rows' pass times for the kernels line
    for r in (MEGA_F32, MEGA_3D):
        for dtype in ("float32", "bfloat16"):
            cfg = mega_config(dict(r, dtype=dtype))
            name = cs._KERNELS[cfg.ndim]

            def one_chunk():
                eng = MegaLaneEngine(cfg, 1, 16, device="cuda", cache={})
                b = fetch_boundary(eng.dispatch_chunk(16), timeout_s=600)
                return b, fetch_boundary(eng.final_snapshot(), timeout_s=600)

            cs.reset_launches()
            gb, gT = one_chunk()
            check(cs.launches[name] > 0, f"the mega chunk never launched {name}")
            with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda",
                                   plain):
                pb, pT = one_chunk()
            same = gb.tobytes() == pb.tobytes() and np.array_equal(
                host_bits(gT), host_bits(pT))
            check(same, f"{name} mega chunk {cfg.n}^{cfg.ndim} {dtype} != plain")
            del gT, pT
            if dtype != "float32":
                continue
            _, kf, padded, _ = mega_launches(cfg, (1,) * cfg.ndim, 16)
            # the chunk's deepest pass: its first block's
            k = max(pass_schedule.passes(padded, dtype, min(kf, 15)))
            bounds = sharded.shard_bounds(cfg.bc, (0,) * cfg.ndim,
                                          (1,) * cfg.ndim, padded, kf)
            A = field(padded, torch_dtype(dtype), seed=5)
            B = torch.empty_like(A)
            ms = event_ms(lambda: cs._launch(A, cfg.r, k, bounds, B), 10)
            one_ms = event_ms(lambda: cs._launch(A, cfg.r, 1, bounds, B), 10)
            plain_ms = event_ms(lambda: cs._pass(A, cfg.r, k, bounds,
                                                 plain=True), 1)
            bound_s, bound_by = dm.pass_bound_s(A.numel(), 4, k,
                                                ndim=cfg.ndim)
            out["kernels"][(name, padded)] = dict(
                rid=r["id"], k=k, ms=ms, one_step_ms=one_ms,
                plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by)
            print(f"  {name} {'x'.join(map(str, padded))} f32 k={k} (the "
                  f"mega chunk's block at kf {kf}): {ms:.4f} ms/pass, the "
                  f"final 1-step pass {one_ms:.4f} ms (plain "
                  f"{plain_ms:.2f} ms, bound {bound_s * 1e3:.4f} ms by "
                  f"{bound_by}, {bound_s * 1e3 / ms:.1%} of it) on {smi}")
            del A, B
        torch.cuda.empty_cache()
    print(f"  4 mega chunks (4096^2 and 512^3, f32 and bf16): kernel = plain "
          f"version, boundary vectors and fields byte-equal")
    print(f"[phase 5d] {time.perf_counter() - t0:.1f} s on {smi}")
    return out


def fleet_copies(ids, prefix, dirs, ref: Path) -> list:
    """The ids whose fleet outputs (``<prefix>-<id>.npz`` in any of
    ``dirs``) are missing or not all byte-equal to ``ref/<id>.npz``."""
    bad = []
    for i in ids:
        want = (ref / f"{i}.npz").read_bytes()
        got = [p.read_bytes() for d in dirs
               for p in [d / f"{prefix}-{i}.npz"] if p.exists()]
        if not got or any(g != want for g in got):
            bad.append(i)
    return bad


def drain_backend(b) -> None:
    """``POST /drainz`` to a ``serve --listen`` backend: it finishes its
    work, prints its summary and exits 0."""
    import urllib.request

    req = urllib.request.Request(f"http://{b.address}/drainz", data=b"",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        r.read()


def backend_summary(b, drained: bool, timeout=120.0) -> dict:
    """The summary line of a ``serve --listen --json`` backend
    (``fleet_lab.BackendProc``) once it has exited. A drained backend
    exits 0; one drained to a checkpoint (a steal's victim) exits 1, its
    requests unfinished there."""
    rc = b.proc.wait(timeout)
    lines = b.log.read_text(errors="replace").splitlines()
    check(rc == (0 if drained else 1),
          f"backend {b.name} exited {rc}: " + "\n".join(lines[-20:]))
    return next(json.loads(x) for x in reversed(lines)
                if x.startswith("{") and '"lane_passes"' in x)


def phase_fleet(smi, serve):
    """Phase 5e, the fleet on the card (see the module docstring): port
    backends as ``serve --listen`` processes behind the fleet router, phase
    5's file through 1, 2 (the ``fleet`` CLI) and 4 of them, the oversized
    request on the mega-capable one, the steal and kill drills and the
    resilience lab. Returns the numbers."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from heat_tpu_torch.labs import fleet_lab as fl
    from heat_tpu_torch.labs import fleet_resilience_lab as frl
    from heat_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    built = sorted(p.name for p in _build.build_dir().glob("lib*.so"))
    reqs = [json.loads(x) for x in
            (WORK / "requests.jsonl").read_text().splitlines()]
    ids = [r["id"] for r in reqs]
    ref = WORK / "serve-cuda"
    work = fl.cell_steps(reqs)
    root = WORK / "fleet"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    args = (*SERVE_ARGS, "--json")
    out = {"waves": {}}

    def lines(prefix, rows=reqs):
        return [dict(r, id=f"{prefix}-{r['id']}") for r in rows]

    # the drills take every second request (2D f32, bf16 and 3D among
    # them), to keep the whole script inside its time limit
    half = reqs[::2]
    half_ids = [r["id"] for r in half]

    def phase5_field(line):
        with np.load(ref / f"{line['id'].split('-', 1)[1]}.npz") as z:
            return z["T"]

    print(f"[phase 5e] 5 backends: python -m heat_tpu_torch serve --listen "
          f"{' '.join(args)} --engine-ckpt-interval 1024 (b1 also "
          f"--mega-lanes 1; b2 and b4 --engine-ckpt-interval 256)")
    t0 = time.perf_counter()
    # checkpoints every 1024 boundaries; 256 for the drills' victims (b2
    # the steal's, b4 the kill's), whose first generation of their wave
    # must come well inside it. b4 serves nothing before the kill drill,
    # so every manifest in its directory is of that wave.
    procs = [fl.BackendProc(name, root, env, serve_args=extra,
                            ckpt_interval=every)
             for name, extra, every in (
                 ("b0", args, 1024),
                 ("b1", (*args, "--mega-lanes", "1"), 1024),
                 ("b2", args, 256), ("b3", args, 1024), ("b4", args, 256))]
    b0, b1, b2, b3, b4 = procs
    cli_router = None
    try:
        for b in procs:
            b.wait_address(180)
        for b in procs:
            b.wait_healthy(60)
        t_up = time.perf_counter() - t0
        # first launches paid before any timed wave: one request of each
        # bucket, dtype and rank, sent to every backend directly
        warm = [dict(r, id=f"warm-{r['id']}", ntime=32) for r in
                (reqs[0], reqs[1], reqs[2], reqs[3], reqs[40], reqs[48])]
        threads = [threading.Thread(target=fl.warm_backend, args=(b, warm))
                   for b in procs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
            check(not t.is_alive(), "a backend's warm-up hung")
        print(f"  5 backends up in {t_up:.1f} s, warm in "
              f"{time.perf_counter() - t0 - t_up:.1f} s more")

        def wave(key, backends, recs, wall, snap):
            per = {n: b["routed"] for n, b in snap["backends"].items()}
            check(sorted(r["id"] for r in recs)
                  == sorted(f"{key}-{i}" for i in ids)
                  and all(r["status"] == "ok" for r in recs),
                  f"fleet wave {key}: not every record ok")
            bad = fleet_copies(ids, key, [b.dir for b in backends], ref)
            check(not bad, f"fleet wave {key}: npz differ from phase 5's: "
                           f"{bad}")
            rate = work / wall
            out["waves"][key] = dict(backends=len(backends), wall_s=wall,
                                     cell_steps_per_s=rate, placed=per,
                                     retries=snap["router"]["retries"])
            print(f"  {len(backends)} backend(s): {len(recs)} records ok, "
                  f"npz byte-equal to phase 5's, wall {wall:.3f} s, "
                  f"{rate:.6g} cell-steps/s ({rate / serve['cell_steps_per_s']:.4f}x "
                  f"phase 5's direct serve, {serve['wall_s']:.3f} s), placed "
                  f"{per}, {snap['router']['retries']} retries")

        # 1. phase 5's file through 1, 2 and 4 backends (the router in
        # this process)
        for key, backends in (("f1", [b0]), ("f2", [b0, b1]),
                              ("f4", [b0, b1, b2, b3])):
            wall, recs, snap = fl.run_wave(backends, lines(key))
            wave(key, backends, recs, wall, snap)
            if key == "f4":
                sample = [0, 20, 40, 47, 48, 55]
                check(fl.check_sample(backends, lines(key), sample,
                                      reference=phase5_field),
                      "fleet_lab.check_sample: a sample differs")

        # 2. through 2 backends behind the fleet CLI in a process of its own
        cli_router = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "fleet", "--backends",
             f"b0={b0.address},b1={b1.address}", "--health-interval", "0.5",
             "--json"], cwd=WORK, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        import select

        ready = select.select([cli_router.stdout], [], [], 120)[0]
        first = cli_router.stdout.readline() if ready else ""
        check("fleet router listening on http://" in first,
              f"the fleet CLI did not come up: {first!r}")
        base = "http://" + first.split("http://")[1].split()[0]

        def status():
            with urllib.request.urlopen(f"{base}/v1/status",
                                        timeout=60) as r:
                return json.loads(r.read())

        check(fl.wait_for(lambda: all(b["probe_passes"] for b in
                                      status()["backends"].values()), 60),
              "the fleet CLI never probed its backends")
        body = "".join(json.dumps(r) + "\n" for r in lines("c2")).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/v1/solve", data=body), timeout=600) as r:
            recs = [json.loads(x) for x in r.read().splitlines() if x]
        wall = time.perf_counter() - t0
        snap = status()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/drainz", data=b""), timeout=60) as r:
            r.read()
        text, _ = cli_router.communicate(timeout=120)
        fsum = json.loads(text.strip().splitlines()[-1])
        check(cli_router.returncode == 0 and fsum["event"] == "fleet_summary"
              and fsum["requests"] == len(ids) and fsum["duplicates"] == 0,
              f"the fleet CLI's summary: {text[-2000:]}")
        cli_router = None
        wave("c2", [b0, b1], recs, wall, snap)
        free, total = torch.cuda.mem_get_info()
        out["card_used_gib"] = (total - free) / 2**30
        w = {k: v["cell_steps_per_s"] for k, v in out["waves"].items()}
        print(f"  scaling, the router in this process: 2 backends "
              f"{w['f2'] / w['f1']:.4f}x and 4 backends "
              f"{w['f4'] / w['f1']:.4f}x the 1-backend fleet's "
              f"cell-steps/s; the 1-backend fleet "
              f"{w['f1'] / serve['cell_steps_per_s']:.4f}x phase 5's direct "
              f"serve; the fleet CLI's router over 2 backends "
              f"{w['c2'] / w['f2']:.4f}x this process's; "
              f"{out['card_used_gib']:.2f} GiB of the card in use with 5 "
              f"backends resident, on {smi}")

        # 3. the oversized request (phase 5d's 4096^2 f32) on b1 only
        rt = fl.make_router([(b.name, b.address) for b in (b0, b1)])
        try:
            fl.wait_probed(rt)
            mega = dict(MEGA_F32, id="fleet-mega")
            t0 = time.perf_counter()
            (rec,) = fl.post_stream(rt, [mega])
            mwall = time.perf_counter() - t0
            snap = rt.snapshot()
        finally:
            rt.close()
        same = ((b1.dir / "fleet-mega.npz").read_bytes()
                == (WORK / "serve-mega" / "mega-f32.npz").read_bytes())
        check(rec["status"] == "ok" and rec["placement"] == "mega"
              and snap["backends"]["b1"]["routed"] == 1
              and snap["backends"]["b0"]["routed"] == 0
              and not (b0.dir / "fleet-mega.npz").exists() and same,
              f"the oversized request: {rec}, placed "
              f"{ {n: b['routed'] for n, b in snap['backends'].items()} }, "
              f"byte-equal {same}")
        out["mega_wall_s"] = mwall
        print(f"  4096^2 f32 x 8192 through the router: placed on b1 only "
              f"(mega capable), placement {rec['placement']}, npz byte-equal "
              f"to phase 5d's, {mwall:.3f} s")

        # 4. the steal drill: b2 loaded, b3 joins, forced steal b2 -> b3
        steal = fl.steal_drill(b2, b3, lines("st", half), root)
        bad = fleet_copies(half_ids, "st", [b2.dir, b3.dir], ref)
        check(steal["all_ok"] and steal["duplicates"] == 0 and not bad,
              f"the steal drill: {steal}, npz differ {bad}")
        out["steal"] = steal
        print(f"  steal b2 -> b3 with {steal['pending_at_steal']} requests "
              f"pending: {steal['recovered_requests']} resumed from "
              f"generation {steal['generation']} + "
              f"{steal['redriven_requests']} re-driven, recovery "
              f"{steal['recovery_s']} s (drain {steal['drain_s']} s, resume "
              f"{steal['resume_s']} s); all {len(half)} ok, no duplicate, npz "
              f"byte-equal to phase 5's")
        summaries = {"b2": backend_summary(b2, drained=False)}

        # 5. the kill drill: SIGKILL b4 mid-wave, b1 survives
        kill = fl.kill_drill([b4, b1], lines("kd", half), root / "flightrec")
        bad = fleet_copies(half_ids, "kd", [b4.dir, b1.dir], ref)
        check(kill["zero_lost"] and kill["zero_duplicates"]
              and kill["victim_recovered"] and kill["flight_dumps"] >= 1
              and kill["generation_at_kill"] > kill["generation_before"]
              and not bad, f"the kill drill: {kill}, npz differ {bad}")
        out["kill"] = kill
        print(f"  kill b4 at its checkpoint generation "
              f"{kill['generation_at_kill']} of this wave (before it "
              f"{kill['generation_before']}), {kill['victim_delivered_before_kill']}"
              f" of its records delivered: the survivor resumed "
              f"{kill['resumed_requests']} request(s) from generation "
              f"{kill['resumed_generation']}; {kill['ok']} of {len(half)} ok, "
              f"none lost, none twice, {kill['flight_dumps']} flight dump, "
              f"npz byte-equal; wave {kill['wall_s']} s, "
              f"{kill['after_kill_s']} s after the kill")

        # 6. the lane passes every surviving backend's engine dispatched
        for b in (b0, b1, b3):
            drain_backend(b)
        for b in (b0, b1, b3):
            summaries[b.name] = backend_summary(b, drained=True)
        for name, s in sorted(summaries.items()):
            check(s["lane_kernel_fallbacks"] == 0
                  and s["lane_passes"].get("lanes2d", 0) > 0,
                  f"backend {name}: {s['lane_passes']}, "
                  f"{s['lane_kernel_fallbacks']} fallbacks")
            print(f"  backend {name}: {s['requests']} requests, lane passes "
                  f"{s['lane_passes']}, placement {s['placement']}, no "
                  f"lane-kernel fallback, {s['compile_s']} s loading "
                  f"kernels")
        check(summaries["b1"]["placement"].get("mega", 0) >= 1,
              "b1 served no mega-lane")
    finally:
        if cli_router is not None and cli_router.poll() is None:
            cli_router.kill()
            cli_router.wait(60)
        for b in procs:
            b.stop()

    now = sorted(p.name for p in _build.build_dir().glob("lib*.so"))
    check(now == built, f"a backend built a kernel library in the phase: "
                        f"{sorted(set(now) - set(built))}")
    print(f"  no backend built a kernel: the {len(built)} libraries of "
          f"phase 1 served every backend")

    # 7. the resilience lab at a small population, f32 on the lane kernels
    # (in-process engines and gateways on the card); its timing gates are
    # printed, not checked
    t0 = time.perf_counter()
    rdir = root / "resilience"
    flap = frl.flap_drill(rdir, 12, frl.SINK_MS, "cuda", "float32")
    cut = frl.cut_drill(rdir, 12, frl.SINK_MS // 2, "cuda", "float32")
    hedge = frl.hedge_drill(rdir, frl.SINK_MS, "cuda", "float32")
    dead = frl.deadline_drill(rdir, 4, 4, "cuda", "float32")
    check(flap["availability"] == 1.0 and flap["bit_identical"]
          and cut["zero_lost"] and cut["zero_duplicates"]
          and hedge["status"] == "ok" and hedge["bit_identical"]
          and dead["shed_exact"],
          f"the resilience lab: {flap} {cut} {hedge} {dead}")
    out["resilience"] = dict(flap=flap, cut=cut, hedge=hedge, deadline=dead)
    print(f"  resilience lab (f32, 12 requests, {time.perf_counter() - t0:.1f}"
          f" s): flap availability {flap['availability']}, p99 ratio "
          f"{flap['p99_ratio']} (the reference's gate <= 1.5: a measurement "
          f"here), {flap['breaker_transitions']} breaker transitions, "
          f"{flap['steals']} steals; stream cut {cut['stream_cuts']}, "
          f"{cut['ok']} of {cut['requests']} ok; hedge fired "
          f"{hedge['fired']} won {hedge['won']} in {hedge['hedged_wall_s']} s "
          f"(stall {hedge['stall_depth_s']} s); deadline {dead['shed_records']}"
          f" shed, {dead['served_records']} served; every byte check equal")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 5e] done in {out['phase_s']:.1f} s on {smi}")
    return out


def nan_bits_equal_cells(a, b):
    """Per cell: both NaN, or the same bytes."""
    return (a.isnan() & b.isnan()) | (bits(a) == bits(b))


def nan_bits_equal(a, b) -> bool:
    """The same NaN cells, and the same bytes everywhere else (the card
    writes a computed NaN as 0x7fffffff, the host as 0x7fc00000: the NaN's
    payload is not part of the function)."""
    import torch

    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return bool(torch.equal(na, nb)
                and torch.equal(bits(a)[~na], bits(b)[~nb]))


def lab_inputs(name, dtype, seed, nan=False):
    """The JAX lab's check shape for ``name``: (padded field on the card,
    logical extent, TPU geometry keywords, the deepest ksteps it allows,
    bounds narrower than the field or None). With ``nan``, one interior
    cell is NaN and the narrower bounds lie 3 cells from it."""
    import torch

    if "3d" in name:
        logical, pad = (40, 24, 300), (40, 24, 384)
        geo = dict(R=8, M=8, k=4, km=4 if name == "lab_3d_tiled" else 8)
        kmax, narrow = 4, (2, 36, 3, 20, 5, 290)
    elif name == "lab_thin2d_variant":
        logical, pad = (96, 260), (128, 384)
        geo, kmax, narrow = dict(tile=32, kpad=16), 16, None
    else:
        logical, pad = (100, 500), (112, 512)
        geo = dict(R=16, C=256, kr=16, kc=128)
        kmax, narrow = 16, (3, 95, 5, 490)
    T = torch.zeros(pad, dtype=dtype, device="cuda")
    T[tuple(slice(0, s) for s in logical)] = field(logical, dtype, seed)
    if nan:
        at = tuple(s // 2 for s in logical)
        T[at] = float("nan")
        narrow = tuple(v for a in at for v in (a - 3, a + 3))
    return T, logical, geo, kmax, narrow


def lab_call(name, variant, T, r, k, logical, geo, bounds, **kw):
    from heat_tpu_torch.ops import cuda_lab as cl

    fn = getattr(cl, name)
    if variant is not None:
        kw["variant"] = variant
    if bounds is not None:
        kw["bounds"] = bounds
    return fn(T, r, k, logical=logical, **geo, **kw)


def phase_lab_compare():
    """Every lab (kernel, variant, dtype) against its plain version on the
    card, bytes: the JAX lab's check shapes at depths 1 and the maximum on
    both compiled tiles, bounds narrower than the field, a NaN planted in an
    interior cell with frozen cells 3 cells away; then the K1-form
    instances against ftcs2d and L1 against ftcs3d on the same inputs.
    Returns max |err| (finite cells) per (kernel, variant)."""
    import torch

    from heat_tpu_torch.ops import cuda_lab as cl
    from heat_tpu_torch.ops import cuda_stencil as cs

    t0 = time.perf_counter()
    errs, ncases = {}, 0
    for (name, variant), form in cl.FORMS.items():
        blocks = cl.BLOCKS_2D if form.ndim == 2 else cl.BLOCKS_3D
        r = 0.2 if form.ndim == 2 else 1 / 6
        for dt in (torch.float32, torch.bfloat16):
            T, logical, geo, kmax, narrow = lab_inputs(name, dt, ncases)
            cases = [(k, block, None, T) for k in (1, kmax) for block in blocks]
            Tn, _, _, _, nb = lab_inputs(name, dt, ncases, nan=True)
            if name == "lab_thin2d_variant":   # it takes no bounds
                nb = None
            # narrower bounds and the NaN in both designs: the streamed tile
            # and the first band tile
            for block in blocks[:2]:
                if narrow is not None:
                    cases.append((kmax, block, narrow, T))
                cases.append((kmax, block, nb, Tn))
            for k, block, bounds, X in cases:
                got = lab_call(name, variant, X, r, k, logical, geo, bounds,
                               block=block)
                want = lab_call(name, variant, X, r, k, logical, geo, bounds,
                                plain=True)
                torch.cuda.synchronize()
                what = (f"{cl.key(name, variant)} {dt_name(dt)} k={k} tile "
                        f"{block} bounds {bounds}")
                g, w = got.float(), want.float()
                fin = torch.isfinite(g) & torch.isfinite(w)
                err = float((g[fin] - w[fin]).abs().max())
                key = cl.key(name, variant)
                errs[key] = max(errs.get(key, 0.0), err)
                if X is Tn:
                    spread = int(torch.isnan(w).sum())
                    check(spread > 1 and (bounds is None or bool(torch.isnan(
                        w[(bounds[0],) + tuple(s // 2 for s in logical[1:])]))),
                          f"the NaN did not spread into frozen cells: {what}")
                    ok = nan_bits_equal(got, want)
                else:
                    ok = torch.equal(bits(got), bits(want))
                if not ok:
                    print(f"  {what}: {int((bits(got) != bits(want)).sum())} "
                          f"cells differ")
                check(ok, f"lab kernel != plain: {what}")
                ncases += 1
    # cuda_lab's 2D tile figures against what lab2d.cu compiled
    for block in cl.BLOCKS_2D:
        for k in range(1, cl.KMAX_2D + 1):
            geo = cl.compiled_geometry(block, k)
            try:
                cl.check_launch(2, block, k)
            except ValueError:
                check(geo is None, f"lab2d compiled tile {block} at k={k}, "
                      f"which check_launch refuses")
                continue
            rw = block[1] if block != cl.STREAM_2D or k <= 16 else 2 * block[1]
            check(geo == (block[0], rw, cl.smem_bytes(block, k)),
                  f"lab2d tile {block} at k={k} compiled as {geo}, cuda_lab "
                  f"says {(block[0], rw, cl.smem_bytes(block, k))}")
    # at the shipped tile the K1-form instances and L1 are the template
    # instances that ftcs2d.cu / ftcs3d.cu build (stencil2d_stream.cuh /
    # stencil3d_stream.cuh), compiled into the lab's libraries: the same
    # input gives the same bytes; and at the band tiles (stencil2d.cuh /
    # stencil3d.cuh, the earlier designs) they give ftcs2d's / ftcs3d's
    # bytes too, in 2D at both streamed shapes (k 16 and 32)
    nsame = 0
    stream2, band2 = cl.STREAM_2D, (64, 96)
    stream3, band3 = cl.STREAM_3D, (16, 16, 32)
    for dt in (torch.float32, torch.bfloat16):
        T2 = field((1000, 4099), dt, seed=3)
        b2 = full_bounds(T2.shape)
        T3 = field((67, 45, 129), dt, seed=4)
        b3 = full_bounds(T3.shape)
        want3 = cs._launch(T3, 1 / 6, 8, b3, None)
        same = [("lab_3d_tiled", None, T3, 1 / 6, 8, b3, want3, stream3),
                ("lab_3d_tiled", None, T3, 1 / 6, 8, b3, want3, band3)]
        for k in (16, 32):
            want2 = cs._launch(T2, 0.2, k, b2, None)
            same += [(name, variant, T2, 0.2, k, b2, want2, block)
                     for name, variant in (
                         ("lab_thin2d_variant", "shrink"),
                         ("lab_thin2d_variant", "rolled"),
                         ("lab_2d_coltiled_rolled", "f32"))
                     for block in (stream2, band2)]
        for name, variant, X, r, k, b, want, block in same:
            got = cl._launch(name, variant, X, r, k, b, block, None)
            check(torch.equal(bits(got), bits(want)),
                  f"{cl.key(name, variant)} {dt_name(dt)} k={k} tile {block} "
                  f"!= the shipped kernel")
            nsame += 1
        torch.cuda.synchronize()
    print(f"[phase 6] {ncases} lab-kernel-vs-plain cases, 0 differing bytes "
          f"(NaN cells alike); {nsame} K1/K3-form launches equal to "
          f"ftcs2d/ftcs3d, in both designs of each "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_lab(smi):
    """The lab's main path: ``kernel_lab.main`` (what ``python -m
    heat_tpu_torch.labs.kernel_lab`` calls) for every check and then
    LAB_BENCHES, the lab launch counts zeroed just before and read just
    after; then each bench row's plain version timed once at its shape (and
    its output held to the kernel's, bytes). Returns (rows, launches)."""
    import torch

    from heat_tpu_torch.labs import kernel_lab
    from heat_tpu_torch.ops import cuda_lab as cl

    t0 = time.perf_counter()
    rows = []
    cl.reset_launches()
    for exp in sorted(kernel_lab.CHECKS):
        print(f"[phase 6] kernel_lab {exp}")
        check(kernel_lab.main([exp]) == 0, f"kernel_lab {exp} failed")
    for argv in LAB_BENCHES:
        print(f"[phase 6] kernel_lab {' '.join(argv)}")
        check(kernel_lab.main(list(argv), results=rows) == 0,
              f"kernel_lab {' '.join(argv)} failed")
    launches = dict(cl.launches)
    print(f"  lab launches: {launches} ({time.perf_counter() - t0:.1f} s)")
    for key, count in launches.items():
        check(count > 0, f"the lab's run never launched {key}")
    for row in rows:
        dt = getattr(torch, row["dtype"])
        T = kernel_lab._field(row["shape"], dt, "cuda")
        k, block, logical = row["k"], row["block"], row["logical"]
        nd = len(logical)
        geo = ((k, k, k, k) if row["name"] != "lab_thin2d_variant"
               else (k, k))
        fn = getattr(cl, row["name"])
        args = (T, 0.25 if nd == 2 else 0.15, k, *geo)
        kw = {} if row["variant"] is None else dict(variant=row["variant"])
        if row["name"] == "lab_thin2d_variant":
            args, kw = args + (row["variant"], logical), {}
        else:
            args = args + (logical,)
        got = fn(*args, block=block, **kw)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        want = fn(*args, plain=True, **kw)
        e1.record()
        e1.synchronize()
        row["plain_ms"] = e0.elapsed_time(e1)      # one call, as phase 2's
        check(torch.equal(bits(got), bits(want)),
              f"{cl.key(row['name'], row['variant'])} at {row['shape']} != "
              f"plain")
        del got, want
        print(f"  {cl.key(row['name'], row['variant'])} "
              f"{'x'.join(map(str, row['shape']))} {dt_name(dt)} k={k} tile "
              f"{'x'.join(map(str, block))}: {row['ms']:.4f} ms/pass, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bound_ms'] / row['ms']:.1%} of it), plain "
              f"{row['plain_ms']:.2f} ms, shipped {row['shipped_ms']:.4f} ms "
              f"({row['ms'] / row['shipped_ms']:.4f}x) on {smi}")
        del T
        torch.cuda.empty_cache()
    print(f"[phase 6] lab done ({time.perf_counter() - t0:.1f} s)")
    return rows, launches


# phase 7: configs/hip.dat (32768^2, sigma 0.25) with ntime cut to 128, and
# a 2048^2 cut of it for the multi-process worlds (soln files at 2048^2)
HIP_DAT = "32768 0.25 0.05 1.0 128 0\n"
HIP_ARGS = ("--variant", "hip", "--dtype", "float32", "--heartbeat-every",
            "0", "--json", "--report-sum")
SMALL_HIP = dict(sigma=0.25, nu=0.05, dom_len=1.0, ic="uniform", bc="ghost",
                 backend="sharded")


@contextlib.contextmanager
def captured_solves():
    """The SolveResult of every solve the CLI runs inside the block."""
    from heat_tpu_torch import backends

    got, real = [], backends.solve

    def spy(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    backends.solve = spy
    try:
        yield got
    finally:
        backends.solve = real


def ndiff_bits(a, b) -> int:
    """Cells whose bits differ between two host fields (bf16 widened to f32
    exactly on fetch, so f32 bits compare both)."""
    import numpy as np

    check(a.shape == b.shape and a.dtype == b.dtype, "field shapes differ")
    return int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))


def block_calls(padded, kf, overlap: bool) -> list:
    """The input shapes of one exchange block's kernel calls on a shard:
    the padded shard, or with ``--exchange overlap`` the interior and
    every region (``sharded.overlap_regions``)."""
    from heat_tpu_torch.backends import sharded

    if not overlap:
        return [tuple(padded)]
    return [shape for _, shape in sharded.overlap_regions(padded, kf)]


def sharded_launches(n, mesh, dtype, ntime, kf, overlap=False) -> tuple:
    """(timed, warm-up) kernel launches of a sharded run with no heartbeat:
    every shard runs ntime // kf blocks of kf steps and one of the
    remainder, each call of a block (``block_calls``) cut into the
    reference's passes at its input shape; the warm-up makes each distinct
    block once."""
    from heat_tpu_torch.ops import pass_schedule

    padded = [n // m + 2 * kf for m in mesh]
    shards = 1
    for m in mesh:
        shards *= m
    n_fused, rem = divmod(ntime, kf)
    calls = block_calls(padded, kf, overlap)
    full = sum(len(pass_schedule.passes(s, dtype, kf)) for s in calls)
    part = (sum(len(pass_schedule.passes(s, dtype, rem)) for s in calls)
            if rem else 0)
    return (shards * (n_fused * full + part),
            shards * ((full if n_fused else 0) + part))


def sharded_main_path(key, input_dat, args, n, mesh, dtype, ntime, smi):
    """One sharded run through the CLI (launch counts zeroed just before
    and read just after); checks the kernel and its launches."""
    from heat_tpu_torch.ops import pass_schedule

    name = "ftcs2d" if len(mesh) == 2 else "ftcs3d"
    overlap = "overlap" in args
    print(f"[phase 7] run --backend sharded {key}")
    with captured_solves() as got:
        out, launches = cli_run(input_dat, *args, backend="sharded")
    res = got[-1]
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["kernel"] == f"cuda {name}", f"kernel {rec['kernel']}")
    check(rec["launches"] == launches, "launch count mismatch")
    check(rec["exchange"] == ("overlap" if overlap else "indep"),
          f"exchange {rec['exchange']}")
    timed, warm = sharded_launches(n, mesh, dtype, ntime, rec["kf"], overlap)
    check(launches[name] == timed + warm,
          f"{launches[name]} {name} launches, expected {timed + warm}")
    padded = [n // m + 2 * rec["kf"] for m in mesh]
    calls = block_calls(padded, rec["kf"], overlap)
    per_block = sum(len(pass_schedule.passes(s, dtype, rec["kf"]))
                    for s in calls)
    print(f"  {key}: {rec['points_per_s']:.6g} points/s, kf {rec['kf']}, "
          f"{rec['exchanges']} exchanges, {launches[name]} {name} launches "
          f"({timed} timed + {warm} warm-up; per shard and exchange block "
          f"{len(calls)} kernel calls, {per_block} launches) on {smi}")
    return rec, res


def single_run(input_dat, args):
    """The single-device cuda run of the same config: (record, result)."""
    with captured_solves() as got:
        out, _ = cli_run(input_dat, *args)
    return json.loads(out.strip().splitlines()[-1]), got[-1]


def start_launch_world(where: Path, input_dat: str, n: int, *args,
                       launch_args=()) -> subprocess.Popen:
    """``python -m heat_tpu_torch launch -n <n> [launch_args] -- run ...``
    started in ``where`` and not waited for: its output goes to
    ``where/launch.out`` and ``launch.err``, and a watcher thread notes
    when it exits (``world_result`` collects it)."""
    import threading

    where.mkdir(parents=True, exist_ok=True)
    (where / "input.dat").write_text(input_dat)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(where / "launch.out", "w") as out, \
            open(where / "launch.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "launch", "-n", str(n),
             "--deadline", "300", *launch_args, "--", "run", "--backend",
             "sharded", *args],
            cwd=where, env=env, stdout=out, stderr=err, text=True,
            start_new_session=True)
    proc.where, proc.t0, proc.t_end, proc.result = (where, time.perf_counter(),
                                                    None, None)

    def watch():
        proc.wait()
        proc.t_end = time.perf_counter()

    proc.watcher = threading.Thread(target=watch, daemon=True)
    proc.watcher.start()
    return proc


def stop_world(proc) -> None:
    """Kill a world's launcher and the ranks it started (its session)."""
    import signal

    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def world_result(proc, timeout: float = 700.0):
    """Wait for a world of ``start_launch_world`` (killed past
    ``timeout`` seconds from its start): a ``CompletedProcess`` with its
    output, and ``wall_s``, its seconds from start to exit, start-up
    included. Collected once; later calls return the same result."""
    if proc.result is None:
        try:
            proc.wait(timeout=max(1.0, proc.t0 + timeout
                                  - time.perf_counter()))
        except subprocess.TimeoutExpired:
            stop_world(proc)
        proc.watcher.join()
        res = subprocess.CompletedProcess(
            proc.args, proc.returncode,
            (proc.where / "launch.out").read_text(),
            (proc.where / "launch.err").read_text())
        res.wall_s = proc.t_end - proc.t0
        proc.result = res
    return proc.result


def launch_world(where: Path, input_dat: str, n: int, *args,
                 launch_args=()):
    """``start_launch_world`` waited for: its ``world_result``."""
    return world_result(start_launch_world(where, input_dat, n, *args,
                                           launch_args=launch_args))


RESTART_ARGS = ("--checkpoint-every", "8", "--async-io", "off")
RESTART_RE = re.compile(r"^launch: restart (\{.*\})$", re.M)


def start_restarted_world(key, input_dat, n_proc, args, run,
                          crash="crash@20:proc=1") -> subprocess.Popen:
    """One of ``restarted_world``'s two worlds started: ``run`` is
    ``clean`` (uninterrupted) or ``crash`` (``--inject crash``), both
    checkpointed under ``launch --max-restarts 2``."""
    extra = () if run == "clean" else ("--inject", crash)
    return start_launch_world(WORK / f"restart_{key}_{run}", input_dat, n_proc,
                              *args, *RESTART_ARGS, *extra,
                              launch_args=("--max-restarts", "2"))


def check_restarted_world(key, worlds: dict, names):
    """The checks of a crashed world against its clean twin (``worlds``:
    ``clean`` and ``crash`` from ``start_restarted_world``): the soln
    files ``names`` and gsum equal, exactly one ``launch_restart`` record,
    resuming at 16 (the crash fires at the 24-step boundary, before that
    boundary's checkpoint). Returns both worlds' records."""
    recs = {}
    for run in ("clean", "crash"):
        proc = world_result(worlds[run])
        check(proc.returncode == 0, f"{key} {run} world rc "
                                    f"{proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        check(rec["kernel"].startswith("cuda ftcs")
              and sum(rec["launches"].values()) > 0,
              f"{key} {run} world ran {rec['kernel']}")
        restarts = [json.loads(m) for m in RESTART_RE.findall(proc.stderr)]
        recs[run] = (rec, restarts, worlds[run].where, proc.wall_s, proc)
    (clean, _, cdir, _, _), (crash_rec, restarts, xdir, wall, proc) = (
        recs["clean"], recs["crash"])
    check(not recs["clean"][1], f"{key}: the clean world restarted")
    same = all((cdir / f).read_bytes() == (xdir / f).read_bytes()
               for f in names)
    print(f"  {key}: restart records {restarts}")
    print(f"  {key}: crashed world gsum {crash_rec['gsum']!r} (clean "
          f"{clean['gsum']!r}), {len(names)} soln files equal: {same}, "
          f"resumed: {'resumed from shard checkpoints at step 16' in proc.stdout}, "
          f"{crash_rec['points_per_s']:.6g} points/s after the resume "
          f"(clean {clean['points_per_s']:.6g}), {wall:.1f} s with the "
          f"restart")
    check(same and crash_rec["gsum"] == clean["gsum"],
          f"{key}: the restarted world differs from the clean one")
    check(len(restarts) == 1 and restarts[0]["event"] == "launch_restart"
          and restarts[0]["resume_step"] == 16 and restarts[0]["rc"] == 43,
          f"{key}: expected one restart resuming at 16, got {restarts}")
    check("resumed from shard checkpoints at step 16" in proc.stdout,
          f"{key}: the world did not resume from the shard files")
    return clean, crash_rec


def restarted_world(key, input_dat, n_proc, args, names, crash="crash@20:proc=1"):
    """A checkpointed world crashed by ``crash`` under ``launch
    --max-restarts 2``, beside the same world uninterrupted, one after the
    other (``check_restarted_world``'s checks). Returns both worlds'
    records."""
    worlds = {}
    for run in ("clean", "crash"):
        worlds[run] = start_restarted_world(key, input_dat, n_proc, args, run,
                                            crash)
        world_result(worlds[run])
    return check_restarted_world(key, worlds, names)


# phase 7's multi-process worlds at 2048^2, started right after the build
# (``start_worlds``) and checked in phase 7
WORLD_DAT = "2048 0.25 0.05 1.0 64 1\n"
WORLD_ARGS = ("--variant", "hip", "--dtype", "float32", "--heartbeat-every",
              "0", "--json", "--report-sum")
MP_WORLDS = (("2 ranks staged", 2, ("--mesh", "2x1", "--comm", "staged")),
             ("1 rank direct", 1, ("--comm", "direct")))
RESTART_KEY = "2048^2 2 ranks staged"


def start_worlds() -> dict:
    """Phase 7's five worlds at 2048^2, started together as child
    processes, each in a directory of its own (``launch`` runs torchrun
    ``--standalone``, which picks its own rendezvous port): 2 ranks staged
    over gloo and 1 rank direct (a 1-rank NCCL world), each held to
    ``--virtual-devices 2`` in phase 7; 2 ranks direct, which must refuse
    on one card; the checkpointed 2-rank staged world clean and crashed at
    step 20 by rank 1. ``main`` starts them after the build, beside the
    card-only tests and phase 2's byte comparisons (none of which times
    anything) and waits for them (``finish_worlds``) before phase 2 times
    anything; their points/s come from a card they shared."""
    worlds = {key: start_launch_world(WORK / f"mp_{n_proc}", WORLD_DAT,
                                      n_proc, *WORLD_ARGS, *extra)
              for key, n_proc, extra in MP_WORLDS}
    worlds["2 ranks direct"] = start_launch_world(
        WORK / "mp_direct2", WORLD_DAT, 2, *WORLD_ARGS, "--mesh", "2x1",
        "--comm", "direct", launch_args=("--max-restarts", "0"))
    for run in ("clean", "crash"):
        worlds[run] = start_restarted_world(
            RESTART_KEY, WORLD_DAT, 2,
            WORLD_ARGS + ("--mesh", "2x1", "--comm", "staged"), run)
    return worlds


def finish_worlds(worlds: dict) -> None:
    """Wait for ``start_worlds``'s children; phase 7 checks them."""
    t0 = time.perf_counter()
    for proc in worlds.values():
        world_result(proc)
    print(f"[phase 7] the five 2048^2 worlds (children beside the card-only "
          f"tests and phase 2's byte comparisons) done, waited "
          f"{time.perf_counter() - t0:.1f} s for them; seconds from start to "
          f"exit: " + ", ".join(f"{k} {world_result(p).wall_s:.1f}"
                                for k, p in worlds.items()))


def intervals_overlap_us(a, b) -> float:
    """Microseconds during which some interval of ``a`` and some of ``b``
    both run (each a list of (start, end) in us)."""
    def merged(xs):
        out = []
        for s, e in sorted(xs):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    total, mb = 0.0, merged(b)
    for s, e in merged(a):
        for s2, e2 in mb:
            total += max(0.0, min(e, e2) - max(s, s2))
    return total


def overlap_window(key, c, mesh, kf, comm, smi, blocks=3):
    """``blocks`` ``--exchange overlap`` blocks at a main path's shard
    shapes (shards on this card, ``LocalComm``) under ``torch.profiler``;
    in the last block: the device time of the interior kernels, of the
    side-stream copies (the staged round trips), and the microseconds in
    which both run. A measurement: "not measured" where the profiler fails
    or sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from heat_tpu_torch.backends import sharded
    from heat_tpu_torch.ops import pass_schedule
    from heat_tpu_torch.parallel import comm as pcomm
    from heat_tpu_torch.parallel import mesh as pmesh

    lc = pcomm.LocalComm(pmesh.RankMesh(mesh), "cuda",
                         staged=comm == "staged")
    step = sharded.make_local_multistep(
        c.with_(exchange="overlap", comm=comm), lc, "cuda")
    padded = [c.n // m + 2 * kf for m in mesh]
    shards = [field(padded, torch.float32, seed=i)
              for i in range(lc.mesh.size)]
    shards = step(shards, kf, kf)   # warm: the buffers, the first launches
    torch.cuda.synchronize()
    trace = WORK / f"overlap_window_{comm}.json"
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(blocks):
                shards = step(shards, kf, kf)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  overlap window {key} {comm}: not measured "
              f"({type(e).__name__}: {e})")
        return None
    device = [ev for ev in events if isinstance(ev.get("args"), dict)
              and "stream" in ev["args"] and "dur" in ev]
    cats = {}
    for ev in device:
        cats[(ev.get("cat"), ev["args"]["stream"])] = cats.get(
            (ev.get("cat"), ev["args"]["stream"]), 0) + 1
    print(f"  overlap window {key} {comm}: device events by (category, "
          f"stream): {sorted(cats.items(), key=str)}")
    # launches of a block: every call in its passes, the interior's first
    passes = [len(pass_schedule.passes(s, "float32", kf)) for s in
              block_calls([c.n // m + 2 * kf for m in mesh], kf, True)]
    kernels = sorted((ev["ts"], ev["ts"] + ev["dur"], ev["args"]["stream"])
                     for ev in device if ev.get("cat") == "kernel"
                     and "ftcs" in ev.get("name", ""))
    per_block = lc.mesh.size * sum(passes)
    if len(kernels) < per_block:
        print(f"  overlap window {key} {comm}: not measured ({len(kernels)} "
              f"ftcs kernels in the trace, {per_block} a block)")
        return None
    # the last block: from the end of the block before it (its copies
    # wait for that) to its last kernel
    t_from = (kernels[-per_block - 1][1] if len(kernels) > per_block
              else float("-inf"))
    kernels = kernels[-per_block:]
    main_stream = kernels[0][2]
    interior = [(s, e) for s, e, _ in kernels[:lc.mesh.size * passes[0]]]
    copies = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in device
              if "memcpy" in str(ev.get("cat", "")).lower()
              and ev["args"]["stream"] != main_stream and ev["ts"] >= t_from]
    t_end = kernels[-1][1]
    t_start = max(t_from, min(s for s, _ in copies + interior))
    busy = [(max(ev["ts"], t_start), min(ev["ts"] + ev["dur"], t_end))
            for ev in device if ev["ts"] < t_end
            and ev["ts"] + ev["dur"] > t_start]
    res = dict(
        busy_us=intervals_overlap_us(busy, [(t_start, t_end)]),
        block_us=t_end - t_start,
        interior_us=sum(e - s for s, e in interior),
        kernels_us=sum(e - s for s, e, _ in kernels),
        copies_us=sum(e - s for s, e in copies), copies=len(copies),
        overlapped_us=intervals_overlap_us(copies, interior),
        overlapped_any_us=intervals_overlap_us(
            copies, [(s, e) for s, e, _ in kernels]),
        window_us=max(e for _, e, _ in kernels) - kernels[0][0])
    print(f"  overlap window, the last of {blocks} blocks of {key} {comm} "
          f"({len(kernels)} ftcs kernels): interior {res['interior_us']:.1f} "
          f"us, all kernels "
          f"{res['kernels_us']:.1f} us, {res['copies']} side-stream copies "
          f"{res['copies_us']:.1f} us, overlapped with the interior "
          f"{res['overlapped_us']:.1f} us (with any kernel "
          f"{res['overlapped_any_us']:.1f} us), first to last kernel "
          f"{res['window_us']:.1f} us; the card busy {res['busy_us']:.1f} us "
          f"of the block's {res['block_us']:.1f} us "
          f"({res['busy_us'] / res['block_us']:.1%}), on {smi}")
    del shards
    torch.cuda.empty_cache()
    return res


def phase_sharded(smi, mega_digest=None, worlds=None):
    """Phase 7, the sharded backend: hip.dat at full width (2x2 shards on
    the one card, staged and direct) and 512^3 (2x2x1) against the
    single-device cuda runs, bytes; the formulations at 8192^2; bf16
    against the plain bounded version on the card; the bounded kernels
    with shard bounds; the multi-process worlds (``worlds``, from
    ``start_worlds``; started here when None); exchange times.
    ``mega_digest`` is the sha256 of phase 5d's hip.dat mega-lane field
    (2x2 shards), held against the first 2x2 run's."""
    import functools
    import itertools
    import math
    from unittest import mock

    import torch

    from heat_tpu_torch import HeatConfig, solve
    from heat_tpu_torch.backends import sharded
    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_stencil as cs
    from heat_tpu_torch.ops import pass_schedule
    from heat_tpu_torch.parallel import comm as pcomm
    from heat_tpu_torch.parallel import halo, mesh as pmesh
    from heat_tpu_torch.utils import torch_dtype

    t0 = time.perf_counter()
    out = {"runs": {}, "times": {}, "kernels": {}}
    main = {}   # main-path run -> (config, mesh, kf)

    # 1. hip.dat, f32 (f64 has no kernel), 128 steps: 2x2 shards, staged
    # then direct, against the single-device cuda run, bytes
    rec1, single = single_run(HIP_DAT, HIP_ARGS)
    T_ref = single.T
    del single
    torch.cuda.empty_cache()
    print(f"  32768^2 f32 single-device cuda: {rec1['points_per_s']:.6g} "
          f"points/s on {smi}")
    out["runs"]["32768 single"] = rec1
    # each beside --exchange overlap (the interior and every region on the
    # kernel while the halo flies): bytes of indep and of the single run
    for comm in ("staged", "direct"):
        T_indep = None
        for form in ("indep", "overlap"):
            key = f"32768 2x2 {comm}" + (" overlap" if form == "overlap"
                                         else "")
            rec, res = sharded_main_path(
                f"32768^2 f32 2x2 {comm} {form}", HIP_DAT,
                HIP_ARGS + ("--virtual-devices", "4", "--mesh", "2x2",
                            "--comm", comm, "--exchange", form), 32768,
                (2, 2), "float32", 128, smi)
            nd = ndiff_bits(res.T, T_ref)
            ni = 0 if T_indep is None else ndiff_bits(res.T, T_indep)
            print(f"  32768^2 2x2 {comm} {form}: {nd} cells differ from the "
                  f"single-device run, {ni} from indep, gsum "
                  f"{rec['gsum']!r} vs {rec1['gsum']!r}")
            check(nd == 0 and ni == 0 and rec["gsum"] == rec1["gsum"],
                  f"32768^2 2x2 {comm} {form} is not the single-device field")
            out["runs"][key] = rec
            main[key] = (res.cfg, res.mesh_shape, rec["kf"])
            if T_indep is None:
                T_indep = res.T
                if mega_digest is not None:
                    import hashlib

                    import numpy as np

                    got = hashlib.sha256(np.ascontiguousarray(
                        res.T).view(np.uint8)).hexdigest()
                    print(f"  32768^2 2x2 {comm} {form} vs phase 5d's "
                          f"mega-lane (2x2): sha256 {got[:16]} / "
                          f"{mega_digest[:16]}, byte-equal "
                          f"{got == mega_digest}")
                    check(got == mega_digest, "phase 5d's hip.dat "
                          "mega-lane is not the 2x2 sharded field")
                    mega_digest = None
            del res
            torch.cuda.empty_cache()
        ratio = (out["runs"][f"32768 2x2 {comm} overlap"]["points_per_s"]
                 / out["runs"][f"32768 2x2 {comm}"]["points_per_s"])
        print(f"  32768^2 2x2 {comm}: overlap {ratio:.4f}x indep points/s on "
              f"{smi}")
        del T_indep
    del T_ref

    # 2. 512^3 f32 at sigma 1/6, 2x2x1 shards, 64 steps, edges and ghost
    dat3 = f"512 {SIGMA_3D!r} 0.05 2.0 64\n"
    for bc in ("edges", "ghost"):
        args = ("--ndim", "3", "--bc", bc, "--dtype", "float32", "--json",
                "--report-sum")
        rec_s, single = single_run(dat3, args)
        out["runs"][f"512^3 single {bc}"] = rec_s
        T_indep = None
        for form in ("indep", "overlap"):
            key = f"512^3 2x2x1 {bc}" + (" overlap" if form == "overlap"
                                         else "")
            rec, res = sharded_main_path(
                f"512^3 f32 2x2x1 {bc} {form}", dat3,
                args + ("--virtual-devices", "4", "--mesh", "2x2x1",
                        "--exchange", form), 512, (2, 2, 1), "float32", 64,
                smi)
            nd = ndiff_bits(res.T, single.T)
            ni = 0 if T_indep is None else ndiff_bits(res.T, T_indep)
            print(f"  512^3 2x2x1 {bc} {form}: {nd} cells differ from the "
                  f"single-device run ({rec_s['points_per_s']:.6g} "
                  f"points/s), {ni} from indep")
            check(nd == 0 and ni == 0,
                  f"512^3 2x2x1 {bc} {form} is not the single-device field")
            out["runs"][key] = rec
            main[key] = (res.cfg, res.mesh_shape, rec["kf"])
            if T_indep is None:
                T_indep = res.T
            del res
            torch.cuda.empty_cache()
        ratio = (out["runs"][f"512^3 2x2x1 {bc} overlap"]["points_per_s"]
                 / out["runs"][f"512^3 2x2x1 {bc}"]["points_per_s"])
        print(f"  512^3 2x2x1 {bc}: overlap {ratio:.4f}x indep points/s on "
              f"{smi}")
        del single, T_indep

    # 3. the formulations at 8192^2, 64 steps: staged = direct, the
    # parity order (IC start) = the default order (both on the torch
    # step, the order the parity path computes in)
    cfg = HeatConfig(n=8192, ntime=64, dtype="float32", mesh_shape=(2, 2),
                     **SMALL_HIP)

    def field_of(c, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return solve(c, virtual_devices=4, **kw).T

    nd = ndiff_bits(field_of(cfg.with_(comm="staged")), field_of(cfg))
    print(f"  8192^2 2x2 staged vs direct: {nd} cells differ")
    check(nd == 0, "8192^2 staged differs from direct")
    torch_base = field_of(cfg.with_(local_kernel="torch"))
    nd = ndiff_bits(field_of(cfg.with_(local_kernel="torch",
                                       parity_order=True)), torch_base)
    print(f"  8192^2 2x2 parity order vs default order (torch step): {nd} "
          f"cells differ")
    check(nd == 0, "parity order (IC start) differs from the default order")
    del torch_base

    # 4. bf16 through the kernel against the same sharded path on the
    # plain bounded version on the card
    plain = functools.partial(cs.ftcs_multistep_bounded_cuda, plain=True)
    bf16_overlap = []
    for c0 in (cfg.with_(dtype="bfloat16"),
               HeatConfig(n=256, ndim=3, sigma=SIGMA_3D, ntime=64,
                          dtype="bfloat16", mesh_shape=(2, 2, 1),
                          bc="ghost", backend="sharded")):
        for c in (c0, c0.with_(exchange="overlap")):
            cs.reset_launches()
            got = field_of(c)
            name = cs._KERNELS[c.ndim]
            check(cs.launches[name] > 0, f"bf16 {c.n} never launched {name}")
            with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda",
                                   plain):
                cs.reset_launches()
                want = field_of(c)
                check(cs.launches[name] == 0, "the plain path launched")
            nd = ndiff_bits(got, want)
            print(f"  {c.n}^{c.ndim} bf16 {'x'.join(map(str, c.mesh_shape))} "
                  f"{c.exchange}: kernel vs plain bounded version, {nd} "
                  f"cells differ")
            check(nd == 0, f"bf16 {c.n}^{c.ndim} {c.exchange} kernel != plain")
            if c.exchange == "overlap":
                kf = sharded.fuse_depth_sharded(c, c.mesh_shape)
                bf16_overlap.append((f"{c.n}^{c.ndim} bf16 overlap", c,
                                     c.mesh_shape, kf))
            del got, want

    # 5. the bounded kernels with shard bounds, corner / edge / inner
    # shards of 3-wide meshes, at kf and at a remainder depth: owned cells
    # (the margins read outside the array, zeros in the kernel, wrapped in
    # the plain version) compared bit for bit
    ncase = 0

    def agree(key, T, r, k, b, owned):
        """The kernel against its plain version on one shard: (max abs
        error on the owned cells, the plain call's ms)."""
        got = cs.ftcs_multistep_bounded_cuda(T, r, k, b)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        want = cs.ftcs_multistep_bounded_cuda(T, r, k, b, plain=True)
        e1.record()
        torch.cuda.synchronize()
        g, w = got[owned], want[owned]
        diff = int((bits(g) != bits(w)).sum())
        check(diff == 0, f"{key} {list(T.shape)} {dt_name(T.dtype)} k={k} "
                         f"bounds {b}: {diff} differ")
        return float((g.float() - w.float()).abs().max()), e0.elapsed_time(e1)

    for nd_, n, mesh in ((2, 6144, (3, 3)), (3, 384, (3, 3, 3))):
        name = cs._KERNELS[nd_]
        r = 0.2 if nd_ == 2 else 0.15
        for dt in (torch.float32, torch.bfloat16):
            kf = sharded.fuse_depth_sharded(
                HeatConfig(n=n, ndim=nd_, dtype=str(dt).replace("torch.", "")),
                mesh)
            padded = [n // m + 2 * kf for m in mesh]
            owned = tuple(slice(kf, -kf) for _ in mesh)
            for role, coords in (("corner", (0,) * nd_),
                                 ("edge", (0,) + (1,) * (nd_ - 1)),
                                 ("inner", (1,) * nd_)):
                for bc in ("edges", "ghost"):
                    for k in (kf, kf - 3):
                        b = sharded.shard_bounds(bc, coords, mesh, padded, kf)
                        T = field(padded, dt, seed=ncase)
                        agree(f"{name} {role} {bc}", T, r, k, b, owned)
                        ncase += 1
                        del T
    print(f"  {ncase} bounded kernel-vs-plain cases at shard shapes, 0 "
          f"differing bytes")

    # 5b. the main path's own shards: each run's padded shard shape, its
    # kf, every pass depth the run cuts kf into, its r and BC, the bounds
    # of each of its shards and of an edge and an inner shard of a 3-wide
    # mesh; the kernel row of phase 7 takes its error from these cases
    # and its plain time from the run's first shard at the deepest pass
    nmain, seen = 0, set()
    for key, (c, mesh, kf) in main.items():
        name = cs._KERNELS[c.ndim]
        padded = [c.n // m + 2 * kf for m in mesh]
        if (tuple(padded), c.bc, c.r, c.dtype) in seen:
            continue    # staged and direct: the same shards
        seen.add((tuple(padded), c.bc, c.r, c.dtype))
        depths = sorted(set(pass_schedule.passes(padded, c.dtype, kf)),
                        reverse=True)
        owned = tuple(slice(kf, -kf) for _ in mesh)
        wide = (3,) * c.ndim
        roles = ([(mesh, co) for co in itertools.product(
                     *(range(m) for m in mesh))]
                 + [(wide, (0,) + (1,) * (c.ndim - 1)), (wide, (1,) * c.ndim)])
        T = field(padded, torch_dtype(c.dtype), seed=nmain)
        row = out["kernels"].setdefault((name, tuple(padded)), dict(
            key=key, kf=kf, k=depths[0], r=c.r, err=0.0,
            bounds=sharded.shard_bounds(c.bc, (0,) * c.ndim, mesh, padded,
                                        kf)))
        for k in depths:
            for m, co in roles:
                b = sharded.shard_bounds(c.bc, co, m, padded, kf)
                err, plain_ms = agree(f"{key} shard {co} of {m}", T, c.r, k,
                                      b, owned)
                row["err"] = max(row["err"], err)
                if row["key"] == key and k == depths[0] and b == row["bounds"]:
                    row["plain_ms"] = plain_ms
                nmain += 1
        del T
        torch.cuda.empty_cache()
        print(f"  {key}: kernel = plain version on {len(roles)} shards' "
              f"bounds at {'x'.join(map(str, padded))}, kf {kf}, pass depths "
              f"{depths}, r {c.r!r}, {c.bc} BC")
    print(f"  {nmain} main-path shard cases, 0 differing bytes")

    # 5c. the overlap runs' kernel calls: the interior (bounds that freeze
    # nothing) and every region of every shard with its shifted bounds, at
    # each run's depths (kf, and the remainder block's), the kept cells
    # against the plain version; the kernel rows of the main path's
    # overlap take a face region's error and plain time from these
    nreg, seen = 0, set()
    overlap_runs = [(key, c, mesh, kf) for key, (c, mesh, kf) in main.items()
                    if c.exchange == "overlap"] + bf16_overlap
    for key, c, mesh, kf in overlap_runs:
        name = cs._KERNELS[c.ndim]
        padded = [c.n // m + 2 * kf for m in mesh]
        depths = {kf} | ({c.ntime % kf} if c.ntime % kf else set())
        regions = sharded.overlap_regions(padded, kf)
        face = max(regions[1:c.ndim + 1], key=lambda rg: rg[1])
        for co in itertools.product(*(range(m) for m in mesh)):
            full = sharded.shard_bounds(c.bc, co, mesh, padded, kf)
            for sigma, shape in regions:
                if not any(sigma):
                    b = [-cs._NO_FREEZE, cs._NO_FREEZE] * c.ndim
                    keep = tuple(slice(kf, s - kf) for s in shape)
                else:
                    origin = [0 if s < 0 else L - 3 * kf if s > 0 else kf
                              for s, L in zip(sigma, padded)]
                    b = [v - origin[j // 2] for j, v in enumerate(full)]
                    keep = tuple(slice(kf, 2 * kf) if s
                                 else slice(kf, L - 3 * kf)
                                 for s, L in zip(sigma, padded))
                for k in sorted(depths, reverse=True):
                    case = (tuple(shape), tuple(b), k, c.dtype, c.r)
                    if case in seen:
                        continue
                    seen.add(case)
                    T = field(shape, torch_dtype(c.dtype), seed=nreg)
                    err, plain_ms = agree(f"{key} region {sigma} of {co}", T,
                                          c.r, k, b, keep)
                    nreg += 1
                    del T
                    if not (c.dtype == "float32" and key in main
                            and (sigma, shape) == face):
                        continue
                    row = out["kernels"].setdefault((name, tuple(shape)), dict(
                        key=key, kf=kf, r=c.r, err=0.0, bounds=b,
                        k=max(pass_schedule.passes(shape, c.dtype, kf)),
                        what="overlap face region"))
                    row["err"] = max(row["err"], err)
        torch.cuda.empty_cache()
        print(f"  {key}: kernel = plain version on the interior and "
              f"{len(regions) - 1} regions of each of {math.prod(mesh)} "
              f"shards at depths {sorted(depths)}")
    print(f"  {nreg} overlap region cases, 0 differing bytes")

    # 6. the multi-process worlds at 2048^2 (``start_worlds``): launch -n 2
    # staged over gloo (two ranks share the card), launch -n 1 direct (a
    # 1-rank NCCL world), against --virtual-devices 2 in this process;
    # launch -n 2 direct must refuse (NCCL puts one rank on one GPU); a
    # checkpointed 2-rank world crashed at step 20 by rank 1 and restarted
    # by the supervisor. Alone (worlds None), the worlds start here.
    if worlds is None:
        worlds = start_worlds()
    out_l, _ = cli_run(WORLD_DAT, *WORLD_ARGS, "--virtual-devices", "2",
                       "--mesh", "2x1", "--comm", "staged",
                       backend="sharded")
    rec_l = json.loads(out_l.strip().splitlines()[-1])
    local = WORK / "mp_local"
    local.mkdir()
    for f in WORK.glob("soln*.dat"):
        f.rename(local / f.name)
    for key, n_proc, _ in MP_WORLDS:
        proc = world_result(worlds[key])
        where = worlds[key].where
        print("".join(f"    | {line}\n" for line in
                      proc.stdout.splitlines()[-4:]), end="")
        check(proc.returncode == 0,
              f"launch {key} rc {proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        check(rec["kernel"] == "cuda ftcs2d" and rec["launches"]["ftcs2d"] > 0,
              f"launch {key} ran {rec['kernel']}")
        names = ["soln.dat"] + (["soln00000.dat", "soln00001.dat"]
                                if n_proc == 2 else [])
        differ = [f for f in names
                  if (where / f).read_bytes() != (local / f).read_bytes()]
        same = not differ
        print(f"  launch {key}: gsum {rec['gsum']!r} (in-process "
              f"{rec_l['gsum']!r}), {', '.join(names)} equal: {same}, "
              f"{rec['points_per_s']:.6g} points/s on a card shared with "
              f"the other worlds, {proc.wall_s:.1f} s with start-up")
        check(same and rec["gsum"] == rec_l["gsum"],
              f"launch {key} differs from the in-process run (gsum "
              f"{rec['gsum']!r} against {rec_l['gsum']!r}; files differing: "
              f"{differ})")
        out["runs"][f"2048 launch {key}"] = rec
    proc = world_result(worlds["2 ranks direct"])
    refused = proc.returncode != 0 and "--comm staged" in proc.stderr
    print(f"  launch 2 ranks direct on one card: rc {proc.returncode}, "
          f"refused naming --comm staged: {refused}")
    check(refused, "launch -n 2 --comm direct did not refuse")
    clean, crashed = check_restarted_world(
        RESTART_KEY, worlds, ["soln.dat", "soln00000.dat", "soln00001.dat"])
    out["runs"]["2048 restarted world"] = crashed
    out["runs"]["2048 clean checkpointed world"] = clean

    # 7. times: one exchange alone (CUDA events) at the main path's shard
    # shapes and kf, and each kernel's deepest pass at its shard shape
    dm = device_model(0)
    for key in ("32768 2x2 direct", "512^3 2x2x1 ghost"):
        c, mesh, kf = main[key]
        for comm in ("direct", "staged"):
            lc = pcomm.LocalComm(pmesh.RankMesh(mesh), "cuda",
                                 staged=comm == "staged")
            shards = [torch.zeros([c.n // m + 2 * kf for m in mesh],
                                  device="cuda") for _ in range(lc.mesh.size)]
            ms = event_ms(lambda: halo.halo_exchange(shards, lc, 1.0,
                                                     width=kf), 10)
            per = lc.stats["bytes"] / lc.stats["exchanges"]
            out["times"][f"exchange {key} {comm}"] = dict(ms=ms, bytes=per)
            print(f"  one {comm} exchange at {key} (kf {kf}): {ms:.4f} ms, "
                  f"{per:.0f} bytes received by the shards, on {smi}")
            del shards
    for key, name in (("32768 2x2 direct overlap", "32768^2 2x2"),
                      ("512^3 2x2x1 edges overlap", "512^3 2x2x1 edges")):
        c, mesh, kf = main[key]
        for comm in ("staged", "direct"):
            out["times"][f"overlap window {name} {comm}"] = overlap_window(
                name, c, mesh, kf, comm, smi)
    for (name, shape), t in out["kernels"].items():
        A = field(shape, torch.float32, seed=3)
        B = torch.empty_like(A)
        ms = event_ms(lambda: cs._launch(A, t["r"], t["k"], t["bounds"], B),
                      20)
        if "plain_ms" not in t:   # one plain pass at the row's depth
            t["plain_ms"] = event_ms(lambda: cs._pass(
                A, t["r"], t["k"], t["bounds"], plain=True), 1)
        bound_s, bound_by = dm.pass_bound_s(A.numel(), 4, t["k"],
                                            ndim=len(shape))
        t.update(ms=ms, bound_ms=bound_s * 1e3, bound_by=bound_by)
        print(f"  {name} {'x'.join(map(str, shape))} f32 k={t['k']} "
              f"({t.get('what', 'shard')} (0, ...) of {t['key']}): "
              f"{ms:.4f} ms/pass (plain "
              f"{t['plain_ms']:.2f} ms, bound {bound_s * 1e3:.4f} ms by "
              f"{bound_by}, {bound_s * 1e3 / ms:.1%} of it) on {smi}")
        del A, B
        torch.cuda.empty_cache()
    print(f"[phase 7] sharded backend done ({time.perf_counter() - t0:.1f} s)")
    return out


def start_guard_checks() -> dict:
    """``python -m heat_tpu_torch check`` and ``check --strict-allows`` as
    child processes (CPU only: the AST tier reads the tree), started at the
    top of the script; ``phase_invariants`` waits for them."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {}
    for name, extra in (("check", ()), ("check --strict-allows",
                                         ("--strict-allows",))):
        log = open(WORK / f"{name.replace(' ', '')}.log", "w")
        try:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "heat_tpu_torch", "check", *extra],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()
    return procs


def start_audit():
    """``python -m heat_tpu_torch audit --json`` on the card as a child
    process, started once the kernels are built (its families are a few
    small dispatches); ``phase_invariants`` waits for it."""
    log = open(WORK / "audit.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "audit", "--json"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def wait_child(proc, log: Path, what: str, timeout: float) -> str:
    """Wait for ``proc`` at most ``timeout`` seconds (killed then) and
    return its log; a child that fails or outlasts the wait fails the
    phase."""
    return wait_child_rc(proc, log, what, timeout, (0,))


def wait_child_rc(proc, log: Path, what: str, timeout: float, ok_rcs) -> str:
    """``wait_child`` where any exit code in ``ok_rcs`` is a finished run
    (a lab or gate that reports its failed checks with rc 1)."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out = log.read_text()
    check(rc in ok_rcs, f"{what} exited {rc}:\n{out[-4000:]}")
    return out


def armed_env() -> dict:
    """The environment that arms the lock-order watchdog and the race
    sanitizer (record mode: a race is logged and counted, not raised)."""
    return {**os.environ, "PYTHONPATH": str(ROOT), "HEAT_TPU_LOCKCHECK": "1",
            "HEAT_TPU_RACECHECK": "record"}


def armed_serve_child() -> None:
    """The child of phase 5f's armed serve: phase 5's file through the
    same CLI entry point and the same wall clock as phase 5, written to
    ``serve-armed.json``."""
    rc, rows, summary, launches, wall = cli_serve_rows(
        WORK / "requests.jsonl", WORK / "serve-armed", echo=False)
    (WORK / "serve-armed.json").write_text(json.dumps(dict(
        rc=rc, rows=rows, summary=summary, launches=launches, wall=wall)))


def guard_clean(what: str, guard) -> str:
    """Check an armed run's ``invariant_guard`` report: both checkers
    armed, zero lock-order violations, zero races. Returns a line."""
    check(guard is not None and guard["lockcheck"] and guard["racecheck"],
          f"{what}: no armed invariant_guard report ({guard})")
    check(guard["lock_order_violations"] == 0 and guard["races_detected"] == 0,
          f"{what}: lock-order violations {guard['violations']}, races "
          f"{guard['race_findings']}")
    return (f"0 lock-order violations over {guard['lock_order_edges']} "
            f"edge(s) (ranks taken: {guard['ranks_taken']}), 0 races on "
            f"{guard['race_instrumented']} instrumented object(s)")


def phase_invariants(smi, serve, checks: dict, audit_proc):
    """Phase 5f, the invariant guard on the card (see the module
    docstring). ``checks`` and ``audit_proc`` are the children
    ``start_guard_checks`` and ``start_audit`` started; ``serve`` is phase
    5's result. Returns the numbers and the armed resilience lab's child,
    which ``finish_invariants`` waits for."""
    t_phase = time.perf_counter()
    out = {}
    # 1. the AST tier over the tree
    for name, proc in checks.items():
        log = wait_child(proc, WORK / f"{name.replace(' ', '')}.log",
                         f"python -m heat_tpu_torch {name}", 120)
        last = log.strip().splitlines()[-1]
        check("OK" in last and "0 violation(s)" in last,
              f"{name}: {last!r}")
        print(f"[phase 5f] python -m heat_tpu_torch {name}: {last}")

    # 2. the program auditor on the card
    log = wait_child(audit_proc, WORK / "audit.log",
                     "python -m heat_tpu_torch audit --json", 180)
    report = json.loads(log.strip().splitlines()[-1])
    check(report["violations"] == 0 and report["device"].startswith("cuda")
          and report["dispatched"] == report["families"],
          f"audit: {report.get('violation_list')}")
    launched = {}
    for name, fam in sorted(report["programs"].items()):
        for k, n in fam["launches"].items():
            launched[k] = launched.get(k, 0) + n
        print(f"  audit {name}: kernels {fam['kernels'] or ['none']}, "
              f"launches {fam['launches']}")
    check(all(launched.get(k, 0) > 0 for k in ("ftcs2d", "ftcs3d", "lanes2d",
                                               "lanes3d")),
          f"audit: kernels not launched: {launched}")
    print(f"[phase 5f] audit --json on the card: {report['dispatched']} "
          f"families, contracts {report['contracts']}, launch budget "
          f"{report['budget']['enumerated']['total']} of "
          f"{report['budget']['declared']}, 0 violations; launches "
          f"{launched} ({report['card']})")
    out["audit"] = dict(families=report["dispatched"], launches=launched)

    # 3. phase 5's file served armed, in a child process
    t0 = time.perf_counter()
    log = open(WORK / "serve-armed.log", "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke as c; c.armed_serve_child()"],
            cwd=ROOT, env=armed_env(), stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    try:
        wait_child(proc, WORK / "serve-armed.log", "the armed serve", 300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = json.loads((WORK / "serve-armed.json").read_text())
    recs = [r for r in res["rows"] if r.get("event") == "serve_request"]
    ids = [r["id"] for r in serve["records"]]
    check(res["rc"] == 0 and len(recs) == len(ids)
          and all(r["status"] == "ok" for r in recs),
          f"armed serve: rc {res['rc']}, "
          f"{[(r['id'], r['status']) for r in recs if r['status'] != 'ok']}")
    bad = npz_differ(ids, WORK / "serve-cuda", WORK / "serve-armed")
    check(not bad, f"armed serve: npz differ from phase 5's: {bad}")
    falls = [r for r in res["rows"] if r.get("event") == "lane_kernel_fallback"]
    check(not falls and not res["summary"]["lane_kernel_fallbacks"]
          and res["launches"]["lanes2d"] > 0 and res["launches"]["lanes3d"] > 0,
          f"armed serve: fallbacks {falls}, launches {res['launches']}")
    line = guard_clean("armed serve", res["summary"].get("invariant_guard"))
    print(f"[phase 5f] phase 5's {len(ids)} requests armed "
          f"(HEAT_TPU_LOCKCHECK=1 HEAT_TPU_RACECHECK=record): every record "
          f"ok, every npz byte-equal to phase 5's, launches "
          f"{res['launches']}, no fallback; {line}")
    print(f"  serve wall armed {res['wall']:.3f} s, unarmed (phase 5) "
          f"{serve['wall_s']:.3f} s: {res['wall'] / serve['wall_s']:.4f}x "
          f"(printed, not gated; child {time.perf_counter() - t0:.1f} s "
          f"with start-up) on {smi}")
    out["serve_wall_armed_s"] = res["wall"]
    out["serve_wall_s"] = serve["wall_s"]

    # 4. the resilience lab armed, in a child process that runs beside
    # phase 6's byte comparisons (finish_invariants waits for it)
    log = open(WORK / "resilience-armed.log", "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch.labs.fleet_resilience_lab",
             "--requests", "12", "--dtype", "float32", "--gates", "bytes",
             "--workdir", str(WORK / "resilience-armed"), "--out",
             str(WORK / "fleet_resilience_armed.json")],
            cwd=ROOT, env=armed_env(), stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 5f] done in {out['phase_s']:.1f} s on {smi} (the armed "
          f"resilience lab runs on beside phase 6's byte comparisons)")
    return out, proc


def finish_invariants(proc, t_started: float) -> None:
    """Wait for phase 5f's armed resilience lab (started at
    ``t_started``) and check its record."""
    t0 = time.perf_counter()
    try:
        wait_child(proc, WORK / "resilience-armed.log",
                   "the armed resilience lab", 300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec = json.loads((WORK / "fleet_resilience_armed.json").read_text())
    line = guard_clean("armed resilience lab", rec.get("invariant_guard"))
    print(f"[phase 5f] fleet_resilience_lab --requests 12 --dtype float32 "
          f"--gates bytes, armed: flap availability "
          f"{rec['flap_availability']} bytes {rec['flap_bit_identical']}, "
          f"cut lost 0 {rec['cut_zero_lost']} dup 0 "
          f"{rec['cut_zero_duplicates']}, hedge bytes "
          f"{rec['hedge_bit_identical']}, deadline exact "
          f"{rec['deadline_shed_exact']}; p99 ratio {rec['flap_p99_ratio']} "
          f"(printed, beside phase 6's byte comparisons); {line} "
          f"({time.perf_counter() - t_started:.1f} s in all, "
          f"{time.perf_counter() - t0:.1f} s waited for)")


def start_child(name: str, *argv) -> subprocess.Popen:
    """``python <argv>`` from the repository root, its output to
    ``WORK/<name>.log``."""
    log = open(WORK / f"{name}.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=log,
            stderr=subprocess.STDOUT)
    finally:
        log.close()


def start_perfcheck() -> subprocess.Popen:
    """Phase 5g's ``perfcheck --no-fresh`` over the committed lab records:
    no device, so started at the top of the script."""
    return start_child("perfcheck", "-m", "heat_tpu_torch", "perfcheck",
                       "--no-fresh")


def start_lane_lab() -> subprocess.Popen:
    """Phase 5g's lane-kernel lab at 16 requests on the card, started
    beside phase 6's byte comparisons."""
    return start_child("lane-kernel-lab", "-m",
                       "heat_tpu_torch.labs.serve_lane_kernel_lab",
                       "--requests", "16", "--out",
                       str(WORK / "serve_lane_kernel_lab.json"))


def perfcheck_key(line: str) -> str:
    """The check a ``perfcheck`` result line reports: ``"<record>:
    <field>"`` for a record's gate, the check's name otherwise (an
    informational check's name ends at its parenthesis)."""
    name, _, detail = line[5:].partition(": ")
    if name.endswith(".json"):
        return f"{name}: {detail.split('=')[0]}"
    return name.split(" (")[0]


def phase_perfcheck(smi, perfcheck, lane_lab, t_started: float) -> dict:
    """Phase 5g (see the module docstring): wait for the children of
    ``start_perfcheck`` and ``start_lane_lab`` (the lab started at
    ``t_started``) and check them."""
    t0 = time.perf_counter()
    try:
        wait_child_rc(lane_lab, WORK / "lane-kernel-lab.log",
                      "the lane-kernel lab", 300, (0, 1))
        out = wait_child_rc(perfcheck, WORK / "perfcheck.log",
                            "perfcheck --no-fresh", 120, (0, 1))
    finally:
        for proc in (perfcheck, lane_lab):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rec = json.loads((WORK / "serve_lane_kernel_lab.json").read_text())
    launched = (rec["cuda"]["launches"]["lanes2d"],
                rec["solo_cuda"]["launches"]["ftcs2d"])
    check(rec["platform"] == "cuda" and rec["bit_identical"]
          and rec["solo_sample_identical"] and rec["zero_fallbacks"]
          and rec["cuda"]["ok"] == rec["torch"]["ok"] == 16
          and min(launched) > 0 and rec["torch"]["launches"]["lanes2d"] == 0,
          f"lane-kernel lab: bit_identical {rec['bit_identical']}, "
          f"solo_sample_identical {rec['solo_sample_identical']}, "
          f"zero_fallbacks {rec['zero_fallbacks']}, launches {launched}")
    print(f"[phase 5g] serve_lane_kernel_lab --requests 16 on the card: "
          f"bit_identical, solo_sample_identical, zero_fallbacks true; "
          f"lanes2d {launched[0]} launches against the plain lane body, "
          f"ftcs2d {launched[1]} in the solo solves; cuda "
          f"{rec['cuda']['points_per_s']:.6g} cell-steps/s, torch "
          f"{rec['torch']['points_per_s']:.6g}, solo cuda "
          f"{rec['solo_cuda']['points_per_s']:.6g} (printed, not gated)")
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("OK   ", "FAIL "))]
    tally = out.strip().splitlines()[-1] if out.strip() else ""
    print("[phase 5g] python -m heat_tpu_torch perfcheck --no-fresh over "
          "heat_tpu_torch/labs/artifacts:")
    print("".join(f"    | {ln}\n" for ln in lines), end="")
    print(f"    | {tally}")
    fails = [ln for ln in lines if ln.startswith("FAIL ")]
    wrong = [ln for ln in fails if perfcheck_key(ln) not in PERFCHECK_SPEED]
    check(lines and tally.startswith("perfcheck: ") and not wrong,
          f"perfcheck: correctness checks failed: {wrong or tally!r}")
    slow = [ln for ln in fails if ln not in wrong]
    print(f"[phase 5g] perfcheck speed and band checks that fail on the "
          f"card ({len(slow)}; kept in PERF.md, not gated here):")
    print("".join(f"    | {ln}\n" for ln in slow) or "    | none\n", end="")
    phase_s = time.perf_counter() - t_started
    print(f"[phase 5g] done: {len(lines) - len(fails)}/{len(lines)} checks "
          f"OK, every correctness check OK; {phase_s:.1f} s since the "
          f"children started, {time.perf_counter() - t0:.1f} s waited for, "
          f"on {smi}")
    return dict(phase_s=phase_s, fails=slow, launches=launched)


def phase_card_tests():
    """The card-only pytest cases (``tests/test_torch_card.py``, which
    imports neither JAX nor heat_tpu): every case must pass; a skip or a
    failure fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "cuda", "-q", "-rs",
         "tests/test_torch_card.py"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print("".join(f"    | {line}\n" for line in lines[-12:]), end="")
    summary = lines[-1] if lines else ""
    check(proc.returncode == 0 and "passed" in summary
          and not re.search(r"skipped|failed|error|deselected", summary),
          f"card-only pytest cases: {summary!r} (rc {proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    print(f"[phase card] tests/test_torch_card.py -m cuda: {summary} "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_worlds():
    """``python3 chip_smoke.py --worlds``, on a host with several cards:
    worlds of one rank per card (``launch -n <cards> -- run --backend
    sharded``), ``--comm direct`` (NCCL point to point between the cards)
    and ``--comm staged`` (gloo through host memory), each against the
    same shards in one process (``--virtual-devices <cards>``: shard i on
    card i, slabs copied between the cards): soln files and gsum equal.
    A periodic 2D mesh of size 2 per axis sends both of a rank's slabs to
    one peer, the case NCCL must match in order."""
    import torch

    cards = torch.cuda.device_count()
    check(cards >= 2, f"--worlds needs several cards, found {cards}")
    cases = (("1024 0.2 0.05 2.0 37 1\n", ("--bc", "periodic")),
             ("1024 0.2 0.05 2.0 37 1\n", ("--bc", "ghost", "--dtype",
                                            "bfloat16", "--exchange", "seq",
                                            "--mesh", f"{cards}x1")),
             ("128 0.15 0.05 2.0 21 1\n", ("--ndim", "3", "--bc", "edges")))
    common = ("--dtype", "float32", "--heartbeat-every", "0", "--json",
              "--report-sum")
    for i, (dat, args) in enumerate(cases):
        args = common + args
        out, _ = cli_run(dat, *args, "--virtual-devices", str(cards),
                         backend="sharded")
        local_rec = json.loads(out.strip().splitlines()[-1])
        local = WORK / f"worlds_local_{i}"
        local.mkdir()
        for f in WORK.glob("soln*.dat"):
            f.rename(local / f.name)
        names = sorted(f.name for f in local.iterdir())
        check(len(names) == cards + 1, f"{len(names)} soln files")
        for comm in ("direct", "staged"):
            where = WORK / f"worlds_{comm}_{i}"
            proc = launch_world(where, dat, cards, *args, "--comm", comm)
            check(proc.returncode == 0,
                  f"launch {comm} rc {proc.returncode}: {proc.stderr[-2000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            same = all((where / f).read_bytes() == (local / f).read_bytes()
                       for f in names)
            print(f"[worlds] {' '.join(args[len(common):])}: {cards} ranks "
                  f"{comm}, mesh {rec['mesh']}, kernel {rec['kernel']}, "
                  f"gsum {rec['gsum']!r} (one process {local_rec['gsum']!r}), "
                  f"{len(names)} soln files equal: {same}")
            check(same and rec["gsum"] == local_rec["gsum"]
                  and rec["kernel"].startswith("cuda ftcs"),
                  f"the {comm} world differs from one process")
    # hip.dat at full width on 2x2 ranks, direct over NCCL between the
    # cards: --exchange overlap beside indep, sums equal (no soln files at
    # this size), points/s of each world
    if cards >= 4:
        recs = {}
        for form in ("indep", "overlap"):
            where = WORK / f"worlds_hip_{form}"
            t_w = time.perf_counter()
            proc = launch_world(where, HIP_DAT, 4, *HIP_ARGS, "--mesh", "2x2",
                                "--comm", "direct", "--exchange", form)
            check(proc.returncode == 0, f"hip.dat {form} world rc "
                                        f"{proc.returncode}: "
                                        f"{proc.stderr[-2000:]}")
            rec = recs[form] = json.loads(proc.stdout.strip().splitlines()[-1])
            check(rec["kernel"] == "cuda ftcs2d" and rec["exchange"] == form
                  and rec["launches"]["ftcs2d"] > 0,
                  f"hip.dat {form} world ran {rec['kernel']}")
            print(f"[worlds] hip.dat 32768^2 f32 ghost, 4 ranks direct "
                  f"(NCCL) {form}: {rec['points_per_s']:.6g} points/s, "
                  f"kf {rec['kf']}, {rec['exchanges']} exchanges, "
                  f"{rec['launches']['ftcs2d']} ftcs2d launches on rank 0, "
                  f"gsum {rec['gsum']!r}, "
                  f"{time.perf_counter() - t_w:.1f} s with start-up")
        check(recs["overlap"]["gsum"] == recs["indep"]["gsum"],
              "the overlap world's sum differs from indep")
        print(f"[worlds] hip.dat overlap "
              f"{recs['overlap']['points_per_s'] / recs['indep']['points_per_s']:.4f}x "
              f"indep points/s across {cards} cards")
    # a checkpointed world of one rank per card, crashed and restarted
    restarted_world(f"1024^2 {cards} ranks direct",
                    "1024 0.2 0.05 2.0 37 1\n", cards,
                    common + ("--bc", "ghost", "--comm", "direct"),
                    ["soln.dat"] + [f"soln{i:05d}.dat" for i in range(cards)])


# ``--labs``: each measuring lab of benchmarks/ ported, at its card size,
# one after another in this process (argv, then the record's name)
LAB_RUNS = (
    ("chip_check", ()),
    ("ckpt_overlap", ("--backend", "cuda", "--n", "4096", "--steps", "256",
                      "--every", "32")),
    ("overlap_ab", ()),
    ("collective_overhead", ()),
    ("weak_scaling", ("--local-n", "16384")),
    ("weak_scaling", ("--virtual", "4", "--local-n", "16384", "--steps",
                      "200")),
    ("sharded3d_check", ()),
    ("run_all", ("--row-timeout", "900")),
)


def lab_gates(name: str, rc: int, rec: dict) -> str:
    """Check a lab record's identity gates (a failed one fails the run)
    and return its headline; speed gates are printed, not checked."""
    if name == "chip_check":
        check(rc == 0 and rec["passed"] == 23, f"chip_check rc {rc}")
        check(min(rec["launches"].values()) > 0, "chip_check launches")
        return (f"{rec['passed']}/23 rows ok, launches {rec['launches']}, "
                f"{rec['seconds']:.1f} s")
    if name == "ckpt_overlap":
        check(rec["bit_identical"] is True, "ckpt_overlap: async checkpoints "
                                            "differ from sync")
        check(rec["launches"]["ftcs2d"] > 0, "ckpt_overlap launched nothing")
        a = rec["rows"]["ckpt_async"]
        return (f"{rec['n']}^2 x {rec['steps']} every {rec['every']}: "
                f"async/baseline {rec['async_vs_baseline']:.4f} (10% gate "
                f"{'PASS' if rec['async_vs_baseline'] <= 1.10 else 'FAIL'}, "
                f"printed), sync/baseline {rec['sync_vs_baseline']:.4f}, "
                f"overlap_s {a['overlap_s']:.4f}, io_wait_s "
                f"{a['io_wait_s']:.4f}, sink {rec['sink_delay_s'] * 1e3:.2f} "
                f"ms; bit-identical; launches {rec['launches']}")
    if name == "overlap_ab":
        check(rc == 0 and all(rec["fields_equal"].values()),
              "overlap_ab: overlap and indep fields differ")
        check(all(r["launches"]["ftcs2d"] > 0 for r in rec["rows"].values()),
              "overlap_ab: a row launched no ftcs2d")
        ex = json.loads((ROOT / "heat_tpu_torch/labs/artifacts/"
                         "exchange_lab.json").read_text())["variants"]
        n2 = rec["n"] ** 2
        return ("; ".join(
            f"fuse {k}: overlap/indep {v:.4f} ("
            f"{n2 / rec['rows'][f'overlap_fuse{k}']['points_per_s_two_point'] * 1e6:.1f}"
            f" against "
            f"{n2 / rec['rows'][f'indep_fuse{k}']['points_per_s_two_point'] * 1e6:.1f}"
            f" us a step)" for k, v in rec["overlap_vs_indep"].items())
            + f"; exchange_lab.json at kf 8: "
              f"{ex['real_advance_overlap_fuse8']['per_step_s'] * 1e6:.1f} "
              f"against {ex['real_advance_indep_fuse8']['per_step_s'] * 1e6:.1f}"
              f" us; fields byte-equal")
    if name == "collective_overhead":
        ed = rec["exchange_delta"]
        check(all(ed[f"fuse_{k}"]["launches"]["ftcs2d"] > 0
                  for k in ed["fit_ks"]), "collective_overhead launches")
        return (f"per-post dispatch {rec['per_post_dispatch_s'] * 1e6:.2f} us; "
                f"fitted C (exchange and pass depth together) "
                f"{ed['per_exchange_s'] * 1e6:.1f} us, t_comp "
                f"{ed['t_step_compute_s'] * 1e6:.1f} us over k {ed['fit_ks']}; "
                f"an exchange alone: " + ", ".join(
                    f"k={k} {ed[f'fuse_{k}']['exchange_alone_s'] * 1e6:.1f} us"
                    for k in ed["fit_ks"]))
    if name == "weak_scaling":
        check(all(r["launches"]["ftcs2d"] > 0 for r in rec["rows"]),
              "weak_scaling: a row launched no ftcs2d")
        return (f"{rec['conditions']['mode']}: " + "; ".join(
            f"{r['devices']} shard(s) {tuple(r['mesh'])} n={r['n']}: "
            f"{r['points_per_s_total']:.6g} pts/s, efficiency "
            f"{r['weak_efficiency']:.4f}" for r in rec["rows"]))
    if name == "sharded3d_check":
        kfs = {str(r["fuse_steps_requested"]): r["kf"] for r in rec["rows"]}
        check(kfs == {"auto": 8, "8": 8, "32": 32},
              f"sharded3d_check fuse depths {kfs}")
        check(all(r["launches"]["ftcs3d"] > 0 for r in rec["rows"]),
              "sharded3d_check: a row launched no ftcs3d")
        return "; ".join(
            f"fuse {r['fuse_steps_requested']}: kf {r['kf']}, "
            f"{r['points_per_s_two_point']:.6g} pts/s, "
            f"{r['launches']['ftcs3d']} ftcs3d launches" for r in rec["rows"])
    if name == "run_all":
        rows = {r["name"]: r for r in rec["rows"]}
        check(rc == 0 and len(rows) == 5
              and not any("error" in r for r in rows.values()),
              f"run_all rc {rc}: {[r.get('error') for r in rows.values()]}")
        for r in rows.values():
            if r["backend"] in ("cuda", "sharded"):
                kname = "ftcs2d" if r["ndim"] == 2 else "ftcs3d"
                check(r["platform"] == "cuda" and r["launches"][kname] > 0,
                      f"run_all {r['name']}: no {kname} launches on the card")
        return "; ".join(
            f"{r['name']} {r['points_per_s']:.6g} pts/s (two-point "
            f"{r['points_per_s_two_point'] or 0:.6g}, roofline_frac "
            f"{r['roofline_frac']:.4f}), {r['kernel']}, launches "
            f"{r['launches']}" for r in rows.values())
    raise KeyError(name)


def phase_labs(smi) -> None:
    """``python3 chip_smoke.py --labs``: each lab of ``LAB_RUNS`` through
    its ``main`` at its card size, its record written to
    ``heat_tpu_torch/labs/artifacts/``, its identity gates checked and its
    headline printed."""
    import importlib

    from heat_tpu_torch.labs._util import ARTIFACTS

    for name, argv in LAB_RUNS:
        mod = importlib.import_module(f"heat_tpu_torch.labs.{name}")
        out = ARTIFACTS / (name + ("_virtual" if "--virtual" in argv else "")
                           + ".json")
        print(f"[labs] python -m heat_tpu_torch.labs.{name} "
              f"{' '.join(argv)}".rstrip(), flush=True)
        t0 = time.perf_counter()
        rc = mod.main([*argv, "--out", str(out)])
        rec = json.loads(out.read_text())
        line = lab_gates(name, rc, rec)
        print(f"[labs] {name}: {line} (rc {rc}, {time.perf_counter() - t0:.1f}"
              f" s) on {smi}", flush=True)
    print("[labs] python -m heat_tpu_torch.bench", flush=True)
    rec, wall = supervised_bench()
    print(f"[labs] bench: {rec['value']:.6g} points/s (raw single call "
          f"{rec['raw_single_call']:.6g}), vs_baseline "
          f"{rec['vs_baseline']:.6f} ({rec['baseline_chip']}), "
          f"{rec['launches_per_call']} ftcs2d launches a call; "
          f"last_bench.json written ({wall:.1f} s) on {smi}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "heat_tpu_torch").is_dir():
        print(f"chip_smoke: no heat_tpu_torch package beside {__file__}; run "
              f"it from the repository root", file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    t0 = time.perf_counter()
    mode = sys.argv[1:]
    if mode in (["--worlds"], ["--labs"]):
        try:
            phase_build()
            if mode == ["--worlds"]:
                phase_worlds()
            else:
                phase_labs(smi)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(f"chip_smoke {mode[0]}: ok in {time.perf_counter() - t0:.1f} s")
        if mode == ["--labs"]:
            print(smi)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
        return 0
    walls = {}      # seconds of each phase, printed at the end

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            walls[name] = round(time.perf_counter() - t, 1)

    plain = start_plain_serve()
    refs = start_plain_refs()
    checks = start_guard_checks()
    perfcheck = start_perfcheck()
    audit = lab_armed = lane_lab = None
    worlds = {}
    try:
        timed("1 build", phase_build)
        worlds = start_worlds()
        timed("0 card tests", phase_card_tests)
        audit = start_audit()
        plain_gsums = timed("3 wait plain refs", plain_refs_result, refs)
        errs = timed("2 compare", phase_compare)
        errs.update(timed("2 lane compare", phase_lane_compare))
        serve_plain = timed("2 wait plain serve", plain_serve_result, plain)
        timed("7 wait worlds", finish_worlds, worlds)
        times = timed("2 times", phase_times)
        times.update(timed("2 lane times", phase_lane_times))
        runs = timed("3 run", phase_main_path, smi, plain_gsums)
        timed("3b calibrate", phase_calibrate, smi, runs)
        timed("3c bench", phase_bench, smi)
        timed("4 oracle", phase_oracle)
        timed("4b chip_check", phase_chip_check, smi)
        serve = timed("5 serve", phase_serve, smi, serve_plain)
        timed("5b semantics", phase_serve_semantics, smi, serve)
        timed("5c front", phase_serving_front, smi, serve)
        mega = timed("5d mega", phase_mega, smi, serve, runs)
        timed("5e fleet", phase_fleet, smi, serve)
        _, lab_armed = timed("5f guard", phase_invariants, smi, serve, checks,
                             audit)
        t_armed = time.perf_counter()
        lane_lab = start_lane_lab()
        lab_errs = timed("6 lab compare", phase_lab_compare)
        timed("5f wait armed lab", finish_invariants, lab_armed, t_armed)
        timed("5g perfcheck", phase_perfcheck, smi, perfcheck, lane_lab,
              t_armed)
        lab_rows, lab_launches = timed("6 lab", phase_lab, smi)
        shard = timed("7 sharded", phase_sharded, smi,
                      mega["requests"]["mega-hip"]["digest"], worlds)
    finally:
        for child in [plain, refs, audit, lab_armed, perfcheck, lane_lab,
                      *checks.values()]:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
        for world in worlds.values():
            stop_world(world)
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"chip_smoke: seconds of each phase {json.dumps(walls)}")
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")

    f32, bf16 = torch.float32, torch.bfloat16
    kernels = []
    for key, name, shape, dt, k, replaces in (
            ("4096 f32", "ftcs2d", (4096, 4096), f32, 16, K1),
            ("32768 f32", "ftcs2d", (32768, 32768), f32, 16, K2),
            ("32768 bf16", "ftcs2d", (32768, 32768), bf16, 16, K2),
            ("512^3 f32", "ftcs3d", (512,) * 3, f32, 8, K3),
            ("512^3 bf16", "ftcs3d", (512,) * 3, bf16, 4, K3),
            ("1024^3 f32", "ftcs3d", (1024,) * 3, f32, 5, K3)):
        t = times[(name, shape, dt, k)]
        launches = runs[key]["launches"][name]
        check(launches > 0, f"main path {key} never launched {name}")
        kernels.append(dict(
            name=f"{name} {'x'.join(map(str, shape))} {dt_name(dt)} k={k}",
            route="cuda", source=SOURCES[name], replaces=replaces,
            launches=launches, max_abs_err=errs[(name, shape)],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    # the lane kernels at the serve main path's buckets: one serving chunk
    # of 8 lanes (k steps: lanes2d two 8-step passes, lanes3d four 4-step
    # passes; band_ms: lanes2d's earlier band design, one 16-step pass,
    # one_pass_ms: the streamed lanes2d in one 16-step pass; step_ms:
    # lanes3d's earlier one-step design, pass8_ms: lanes3d in two 8-step
    # passes, sweep_ms: in passes of each depth; device_ms, band_device_ms
    # and step_device_ms: the device time per chunk, torch.profiler;
    # pass_bound_ms: one pass's bound at the shipped depth),
    # launches those of phase 5 at that bucket and dtype (every lane tier);
    # no single PyTorch call computes the fused lane chunk; bound_ms at the
    # kernels' own operation count, cost_estimate_bound_ms at the
    # reference's
    for name, B, dt, replaces in (("lanes2d", 256, f32, K4),
                                  ("lanes2d", 512, f32, K4),
                                  ("lanes2d", 1024, f32, K4),
                                  ("lanes2d", 1024, bf16, K4),
                                  ("lanes3d", 256, f32, K5)):
        t = times[(name, B, dt)]
        nd = 2 if name == "lanes2d" else 3
        launches = serve["by_bucket"].get(
            f"{name} {B} {str(dt).replace('torch.', '')}", 0)
        check(launches > 0, f"phase 5 never launched {name} at {B + 2}^{nd} "
                            f"{dt_name(dt)}")
        kernels.append(dict(
            name=f"{name} 8x{B + 2}^{nd} {dt_name(dt)} k={t['k']}",
            route="cuda", source=SOURCES[name], replaces=replaces,
            launches=launches,
            max_abs_err=max(v for (n_, _), v in errs.items() if n_ == name),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            **{key: v for key, v in t.items() if key not in (
                "k", "ms", "plain_ms", "bound_ms", "bound_by")}))
    # the kernel lab's candidates (phase 6): one row per (kernel, variant,
    # dtype) benched, launches those of the lab's run; shipped_ms is the
    # shipped kernel (ftcs2d/ftcs3d) at the same shape, dtype and depth
    from heat_tpu_torch.ops import cuda_lab as cl

    for row in lab_rows:
        lkey = cl.key(row["name"], row["variant"])
        nd = cl.FORMS[(row["name"], row["variant"])].ndim
        kernels.append(dict(
            name=(f"{lkey} {'x'.join(map(str, row['shape']))} "
                  f"{dt_name(getattr(torch, row['dtype']))} k={row['k']} tile "
                  f"{'x'.join(map(str, row['block']))}"),
            route="cuda", source=SOURCES[f"lab{nd}d"],
            replaces=L_REPLACES[row["name"]], launches=lab_launches[lkey],
            max_abs_err=lab_errs[lkey], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shipped_ms=row["shipped_ms"]))
    # the sharded main path (phase 7): ftcs2d on the 2x2 shards of
    # hip.dat, ftcs3d on the 2x2x1 shards of 512^3, each at the run's
    # padded shard shape and deepest pass (launches of the run; the error
    # of phase 7's cases at that shape, every pass depth and shard)
    for (name, shape), t in shard["kernels"].items():
        launches = shard["runs"][t["key"]]["launches"][name]
        check(launches > 0, f"sharded main path {t['key']} never launched "
                            f"{name}")
        kernels.append(dict(
            name=(f"{name} {'x'.join(map(str, shape))} f32 k={t['k']} "
                  f"(sharded {t['key'].split()[1]} "
                  f"{t.get('what', 'shard')})"),
            route="cuda", source=SOURCES[name],
            replaces=K2 if name == "ftcs2d" else K3,
            launches=launches, max_abs_err=t["err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    # the mega-lanes (phase 5d): ftcs2d on the 4096^2 mega request's padded
    # shard, ftcs3d on the 512^3 one's, at the chunk's deepest pass (ms,
    # plain and bound of that pass, one_step_ms of the chunk's final
    # step); launches those of the co-scheduled serve (ftcs2d: both
    # 4096^2 mega requests) and of the 512^3 mega serve (ftcs3d); the
    # kernel equalled its plain version byte for byte on one chunk of
    # each shape, f32 and bf16
    for (name, shape), t in mega["kernels"].items():
        launches = (mega["corun_launches"]["ftcs2d"] if name == "ftcs2d"
                    else mega["requests"][t["rid"]]["launches"])
        check(launches > 0, f"the mega path never launched {name}")
        kernels.append(dict(
            name=(f"{name} {'x'.join(map(str, shape))} f32 k={t['k']} "
                  f"(mega-lane {t['rid']})"),
            route="cuda", source=SOURCES[name],
            replaces=K1 if name == "ftcs2d" else K3, launches=launches,
            max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            one_step_ms=t["one_step_ms"]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
