"""Configuration: ``input.dat`` parsing and run options.

The reference drives every variant from a positional whitespace text file
``input.dat`` holding ``n sigma nu dom_len ntime`` (serial form, see
``fortran/serial/heat.f90:13``) with a sixth ``soln`` dump flag in the MPI
variants (``fortran/mpi+cuda/heat.F90:83``). Single-process variants silently
ignore a trailing sixth field, so one file drives every backend — this parser
preserves that contract (both arities accepted everywhere).

The fields, their validation and the derived quantities are those of
``heat_tpu.config`` (kept as a copy: importing ``heat_tpu`` loads JAX). The
backend names follow the port: ``serial`` (numpy oracle), ``torch`` (plain
PyTorch step, the counterpart of ``xla``), ``cuda`` (the hand-written Hopper
kernel, the counterpart of ``pallas``) and ``sharded``. The device a solve
runs on is not a config field — it is an argument of ``backends.solve`` —
so checkpoint fingerprints stay those of the reference.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Optional, Tuple

_DTYPES = ("float64", "float32", "bfloat16")
_BACKENDS = ("serial", "torch", "cuda", "sharded")
_BCS = ("edges", "ghost", "periodic")
_ICS = ("hat", "hat_half", "hat_small", "uniform", "zero", "sine")
_COMMS = ("direct", "staged")
_ASYNC_IO = ("on", "off", "auto")
_ON_NAN = ("abort", "rollback")
_EXCHANGES = ("seq", "indep", "overlap")
_LOCAL_KERNELS = ("auto", "torch", "cuda")

# --serve-lane-kernel grammar (serve/scheduler.py ServeConfig.lane_kernel):
# the serving engine's chunk body per bucket. "auto" = the hand-written lane
# kernels on a CUDA device wherever the bucket has one (f32/bf16), the plain
# PyTorch lane step elsewhere; "cuda"/"torch" force it (an f64 bucket under
# "cuda" degrades to torch as a structured lane_kernel_fallback record +
# counter, never an error). The reference's ("auto", "pallas", "xla").
LANE_KERNELS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    """Full run configuration.

    The first six fields mirror ``input.dat`` exactly; the rest are framework
    options (runtime analogs of the reference's build-time variant choices).
    """

    # --- input.dat fields (fortran/serial/heat.f90:13, mpi+cuda/heat.F90:83)
    n: int = 256                # grid points per side
    sigma: float = 0.25         # CFL number
    nu: float = 0.05            # diffusivity
    dom_len: float = 2.0        # domain length
    ntime: int = 30             # number of timesteps
    soln: bool = False          # dump solution files at the end

    # --- framework options
    ndim: int = 2               # 2 -> 5-point stencil, 3 -> 7-point
    dtype: str = "float32"      # float64 parity / float32 / bfloat16(+f32 acc)
    backend: str = "torch"
    ic: str = "hat"             # initial condition preset (see grid.py)
    bc: str = "edges"           # "edges": frozen boundary cells (serial semantics)
                                # "ghost": Dirichlet-by-ghost ring (MPI semantics)
                                # "periodic": torus topology
    bc_value: float = 1.0       # boundary temperature (unused for periodic)
    comm: str = "direct"        # sharded halo exchange: direct vs host-staged
    exchange: str = "indep"     # sharded ghost-write formulation
    local_kernel: str = "auto"  # sharded per-shard compute kernel
    mesh_shape: Optional[Tuple[int, ...]] = None  # device mesh; None = auto
    heartbeat_every: int = 0    # print "time_it: i" every k steps (0 = off)
    write_int: bool = False     # dump the initial field to int.dat pre-solve
    report_sum: bool = False    # global temperature sum
    checkpoint_every: int = 0   # periodic snapshot interval (0 = off)
    checkpoint_dir: str = "checkpoints"
    async_io: str = "auto"      # checkpoint/numerics I/O pipeline: "on" =
                                # snapshot-and-continue (one device-side
                                # clone at the boundary; D2H + disk write
                                # in a background thread), "off" = the
                                # synchronous fetch-and-save, "auto" = on
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    check_numerics: bool = False  # per-chunk NaN/Inf detection (debug mode)
    on_nan: str = "abort"       # non-finite response under check_numerics:
                                # "abort" raises at the flagged step;
                                # "rollback" restores the last boundary whose
                                # finite flag passed and re-steps
    inject: str = ""            # deterministic fault-injection spec
                                # (runtime/faults.py grammar)
    fuse_steps: int = 0         # cuda temporal blocking: FTCS steps fused
                                # per kernel launch (0 = auto, 1 = off)
    parity_order: bool = False  # sharded-only bit-parity step ordering

    def __post_init__(self):
        if self.n < 3:
            raise ValueError(f"grid size n must be >= 3, got {self.n}")
        if self.ntime < 0:
            raise ValueError(f"ntime must be >= 0, got {self.ntime}")
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {self.dtype!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.bc not in _BCS:
            raise ValueError(f"bc must be one of {_BCS}, got {self.bc!r}")
        if self.ic not in _ICS:
            raise ValueError(f"ic must be one of {_ICS}, got {self.ic!r}")
        if self.comm not in _COMMS:
            raise ValueError(f"comm must be one of {_COMMS}, got {self.comm!r}")
        if self.exchange not in _EXCHANGES:
            raise ValueError(
                f"exchange must be one of {_EXCHANGES}, got {self.exchange!r}")
        if self.local_kernel not in _LOCAL_KERNELS:
            raise ValueError(
                f"local_kernel must be one of {_LOCAL_KERNELS}, got {self.local_kernel!r}")
        # FTCS stability wants sigma <= 1/(2*ndim); allow mildly unstable
        # experiments but reject nonsense outright, in every dimension.
        if self.sigma <= 0 or self.sigma > 10:
            raise ValueError(f"sigma out of range: {self.sigma}")
        if self.fuse_steps < 0:
            raise ValueError(f"fuse_steps must be >= 0, got {self.fuse_steps}")
        if self.async_io not in _ASYNC_IO:
            raise ValueError(
                f"async_io must be one of {_ASYNC_IO}, got {self.async_io!r}")
        if self.on_nan not in _ON_NAN:
            raise ValueError(
                f"on_nan must be one of {_ON_NAN}, got {self.on_nan!r}")
        if self.on_nan == "rollback" and not self.check_numerics:
            raise ValueError(
                "on_nan='rollback' requires check_numerics=True — the "
                "finite flag at each boundary is the rollback trigger")
        if self.inject:
            # fail at parse time, not at step N of a long solve
            from .runtime.faults import parse_spec

            parse_spec(self.inject)

    # --- derived quantities (fortran/serial/heat.f90:15-17,59) -------------
    @property
    def delta(self) -> float:
        """Grid spacing: dom_len / (n - 1)."""
        return self.dom_len / (self.n - 1)

    @property
    def dt(self) -> float:
        """Timestep from the CFL condition: sigma * delta^2 / nu."""
        return (self.sigma * self.delta**2) / self.nu

    @property
    def r(self) -> float:
        """Stencil coefficient nu*dt/delta^2, derived through dt as the
        reference does (fortran/serial/heat.f90:59) so r carries the same
        rounding as in every other variant."""
        return (self.nu * self.dt) / self.delta**2

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) * self.ndim

    @property
    def points(self) -> int:
        return self.n**self.ndim

    def use_async_io(self) -> bool:
        """"auto" resolves to on: the on-loop cost is one device-side clone
        per boundary, against the D2H + write it takes off the loop."""
        return self.async_io != "off"

    def with_(self, **kw) -> "HeatConfig":
        return dataclasses.replace(self, **kw)


def parse_input(path: str | Path) -> HeatConfig:
    """Parse an ``input.dat`` file (5- or 6-field form).

    Field order: ``n sigma nu dom_len ntime [soln]``. Tokens may span
    multiple lines; extra trailing tokens beyond six are ignored.
    """
    text = Path(path).read_text()
    toks = re.split(r"\s+", text.strip())
    if len(toks) < 5:
        raise ValueError(
            f"{path}: expected at least 5 fields 'n sigma nu dom_len ntime', got {toks}"
        )
    n = int(toks[0])
    sigma = float(toks[1])
    nu = float(toks[2])
    dom_len = float(toks[3])
    ntime = int(toks[4])
    soln = bool(int(toks[5])) if len(toks) >= 6 else False
    return HeatConfig(n=n, sigma=sigma, nu=nu, dom_len=dom_len, ntime=ntime, soln=soln)


# Request-JSONL surface of the serving engine (serve/api.py): the physics
# and per-request knobs a tenant may set. Framework-level execution knobs
# (backend, mesh, checkpointing, async_io) are engine policy, not request
# payload — a request naming them is a typo or a privilege confusion, and
# both must reject loudly rather than silently serve different physics.
_REQUEST_KEYS = ("n", "sigma", "nu", "dom_len", "ntime", "ndim", "dtype",
                 "ic", "bc", "bc_value", "inject")

# Request keys the SCHEDULER owns (never part of the physics config): "id"
# names the record, "deadline_ms" bounds the request's wall time from
# submission (overriding the engine-default --serve-deadline), "tenant"
# names the submitting tenant (fair-share accounting + per-tenant quotas),
# "class" picks the SLO class, and "until"/"tol" pick the completion
# semantics — see serve/scheduler.py + serve/policy.py.
_SCHEDULER_KEYS = ("id", "deadline_ms", "tenant", "class", "until", "tol")

# SLO classes of the serving front-end, name -> admission priority (lower is
# more urgent). The class shapes admission order (serve/policy.py edf/fair)
# and never reaches the physics.
SLO_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}
DEFAULT_SLO_CLASS = "standard"
DEFAULT_TENANT = "default"

# Default per-class SLO targets (deadline-hit fraction) for the burn-rate
# monitor (runtime/prof.py BurnMonitor): the error budget a class may spend
# is 1 - target; override per engine with ``--slo-targets``
# (parse_slo_targets below).
SLO_TARGETS = {"interactive": 0.99, "standard": 0.95, "batch": 0.9}

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def validate_slo_fields(tenant, slo_class) -> Tuple[str, str]:
    """Validate (and default) a request's tenant/class pair. Raised errors
    are per-request rejections at the JSONL front door."""
    tenant = DEFAULT_TENANT if tenant is None else str(tenant)
    if not _TENANT_RE.match(tenant):
        raise ValueError(
            f"tenant must match {_TENANT_RE.pattern} (1-64 chars of "
            f"[A-Za-z0-9._-]), got {tenant!r}")
    slo_class = DEFAULT_SLO_CLASS if slo_class is None else str(slo_class)
    if slo_class not in SLO_CLASSES:
        raise ValueError(
            f"class must be one of {sorted(SLO_CLASSES)} (priority order "
            f"{sorted(SLO_CLASSES, key=SLO_CLASSES.get)}), got {slo_class!r}")
    return tenant, slo_class


# Completion semantics of a request: "steps" runs exactly ntime steps;
# "steady" retires the lane once its residual passes a tolerance.
UNTIL_MODES = ("steps", "steady")
DEFAULT_UNTIL = "steps"


def validate_until_fields(until, tol) -> Tuple[str, Optional[float]]:
    """Validate (and default) a request's until/tol pair. ``tol`` is only
    meaningful with ``until=steady``; supplying it on a fixed-step request
    is rejected loudly."""
    until = DEFAULT_UNTIL if until is None else str(until)
    if until not in UNTIL_MODES:
        raise ValueError(
            f"until must be one of {list(UNTIL_MODES)}, got {until!r}")
    if tol is not None:
        if until != "steady":
            raise ValueError(
                f"tol is only valid with until='steady', got until={until!r}")
        try:
            tol = float(tol)
        except (TypeError, ValueError):
            raise ValueError(f"tol must be a positive number, got {tol!r}")
        if not (tol > 0.0) or not math.isfinite(tol):
            raise ValueError(f"tol must be a positive finite number, "
                             f"got {tol!r}")
    return until, tol


def parse_listen(s) -> Tuple[str, int]:
    """``--listen HOST:PORT`` grammar: ':0' / '0' pick an ephemeral port,
    a bare port listens on 127.0.0.1 (the gateway is a front-end, not an
    exposed-by-default service)."""
    text = str(s).strip()
    host, sep, port_s = text.rpartition(":")
    if not sep:
        host, port_s = "", text
    host = host or "127.0.0.1"
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"--listen must be HOST:PORT (port an integer), got {s!r}"
        ) from None
    if not 0 <= port <= 65535:
        raise ValueError(f"--listen port must be in [0, 65535], got {port}")
    return host, port


def parse_tenant_weights(s) -> Tuple[Tuple[str, float], ...]:
    """``--tenant-weights a=4,b=1`` -> (("a", 4.0), ("b", 1.0)). Unlisted
    tenants weigh 1.0 (serve/policy.py FairShareQueue)."""
    out = []
    for tok in str(s).split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, w = tok.partition("=")
        if not sep:
            raise ValueError(
                f"--tenant-weights entries must be NAME=WEIGHT, got {tok!r}")
        tenant, _ = validate_slo_fields(name.strip(), None)
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"--tenant-weights weight must be a number, got {w!r}"
            ) from None
        if not weight > 0:
            raise ValueError(
                f"--tenant-weights weight must be > 0, got {weight}")
        out.append((tenant, weight))
    return tuple(out)


def parse_slo_targets(s) -> Tuple[Tuple[str, float], ...]:
    """``--slo-targets interactive=0.999,batch=0.8`` -> (("interactive",
    0.999), ("batch", 0.8)). Classes must exist (SLO_CLASSES) and targets
    lie strictly in (0, 1) — a target of 1.0 is a zero error budget and
    every burn rate would be infinite; unlisted classes keep the
    SLO_TARGETS defaults."""
    out = []
    for tok in str(s).split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, t = tok.partition("=")
        if not sep:
            raise ValueError(
                f"--slo-targets entries must be CLASS=TARGET, got {tok!r}")
        name = name.strip()
        if name not in SLO_CLASSES:
            raise ValueError(
                f"--slo-targets class must be one of {sorted(SLO_CLASSES)}, "
                f"got {name!r}")
        try:
            target = float(t)
        except ValueError:
            raise ValueError(
                f"--slo-targets target must be a number, got {t!r}"
            ) from None
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"--slo-targets target must be in (0, 1), got {target}")
        out.append((name, target))
    return tuple(out)


def parse_on_off(v, flag: str) -> bool:
    """``on``/``off`` CLI grammar shared by boolean serve knobs."""
    s = str(v).strip().lower()
    if s == "on":
        return True
    if s == "off":
        return False
    raise ValueError(f"{flag} must be 'on' or 'off', got {v!r}")


def parse_dispatch_depth(v) -> int:
    """``--dispatch-depth`` grammar (serve CLI): ``on`` -> 2 (inspect chunk
    i's boundary while chunk i+1 computes), ``off`` -> 0 (fully synchronous
    debugging fallback — fence every boundary), an integer N >= 1 -> keep N
    chunks in flight per bucket group."""
    s = str(v).strip().lower()
    if s == "on":
        return 2
    if s == "off":
        return 0
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"--dispatch-depth must be 'on', 'off', or an integer >= 1, "
            f"got {v!r}") from None
    if n < 1:
        raise ValueError(
            f"--dispatch-depth integer form must be >= 1 (use 'off' for "
            f"the synchronous fallback), got {n}")
    return n


def parse_mega_lanes(v) -> Optional[int]:
    """``--mega-lanes`` grammar (serve CLI): ``auto`` (default) -> None,
    resolved by the engine to 1 on a multi-device host and 0 on a
    single-device one; an integer N >= 0 pins the concurrent mega-lane
    budget (0 = bucket overflow stays a rejection)."""
    s = str(v).strip().lower()
    if s == "auto":
        return None
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"--mega-lanes must be 'auto' or an integer >= 0, got {v!r}"
        ) from None
    if n < 0:
        raise ValueError(f"--mega-lanes must be >= 0, got {n}")
    return n


def config_from_request(d) -> HeatConfig:
    """Build a HeatConfig from one parsed serve-request object.

    The scheduler's keys (``_SCHEDULER_KEYS``) are skipped, everything else
    must be a known request key; HeatConfig's own __post_init__ then
    validates values exactly as it does for the CLI, so a request cannot
    express a config the solo path would reject."""
    unknown = set(d) - set(_REQUEST_KEYS) - set(_SCHEDULER_KEYS)
    if unknown:
        raise ValueError(
            f"unknown request key(s) {sorted(unknown)}; allowed: "
            f"{sorted(_REQUEST_KEYS)} (+ optional {sorted(_SCHEDULER_KEYS)})")
    kw = {k: d[k] for k in _REQUEST_KEYS if k in d}
    # JSON numbers arrive untyped: pin the integer fields (a float n would
    # sail through range validation and break shapes much later)
    for k in ("n", "ntime", "ndim"):
        if k in kw:
            kw[k] = int(kw[k])
    for k in ("sigma", "nu", "dom_len", "bc_value"):
        if k in kw:
            kw[k] = float(kw[k])
    return HeatConfig(**kw)


def write_input(cfg: HeatConfig, path: str | Path) -> None:
    """Write the 6-field ``input.dat`` form (readable by every variant)."""
    # repr keeps full precision: a write/parse round-trip must not perturb
    # the physics (dt, r, checkpoint fingerprints).
    Path(path).write_text(
        f"{cfg.n} {cfg.sigma!r} {cfg.nu!r} {cfg.dom_len!r} {cfg.ntime} {int(cfg.soln)}\n"
    )


# Named presets reproducing each reference variant's semantics (IC/BC
# families differ silently between variants). The single-process Fortran
# variants write int.dat and print "time_it:" every step; the MPI variants
# heartbeat without an int.dat; the python variants do neither.
VARIANTS = {
    # fortran/serial/heat.f90: hat IC on [0.5,1.5]^2, frozen boundary cells
    "serial": dict(ic="hat", bc="edges", backend="serial", dtype="float64",
                   write_int=True, heartbeat_every=1),
    # fortran/cuda_kernel/heat.F90:99: hat with y in [0.5,1.0]. f64 takes
    # the torch step on the cuda backend (the kernel has no f64 path); run
    # with --dtype float32 to exercise the hand-written kernel itself.
    "cuda_kernel": dict(ic="hat_half", bc="edges", backend="cuda", dtype="float64",
                        write_int=True, heartbeat_every=1),
    "cuda_managed": dict(ic="hat_half", bc="edges", backend="cuda", dtype="float64",
                         write_int=True, heartbeat_every=1),
    # fortran/cuda_cuf/heat.F90:86: same IC family, compiler-generated kernels
    "cuda_cuf": dict(ic="hat_half", bc="edges", backend="torch", dtype="float64",
                     write_int=True, heartbeat_every=1),
    # fortran/mpi+cuda/heat.F90:243-251: uniform 2.0, Dirichlet-by-ghost walls
    "mpi_cuda": dict(ic="uniform", bc="ghost", backend="sharded", comm="direct",
                     dtype="float64", heartbeat_every=1),
    "mpi_cuda_na": dict(ic="uniform", bc="ghost", backend="sharded", comm="staged",
                        dtype="float64", heartbeat_every=1),
    # fortran/hip/heat.F90: always-staged swap
    "hip": dict(ic="uniform", bc="ghost", backend="sharded", comm="staged",
                dtype="float64", heartbeat_every=1),
    # python/serial/heat.py: hat on [0.5,1.0]^2 w/ per-step edge reassert
    "python_serial": dict(ic="hat_small", bc="edges", backend="serial", dtype="float64"),
    # python/cuda/cuda.py: throughput benchmark
    "python_cuda": dict(ic="uniform", bc="edges", backend="cuda", dtype="float32"),
}


def variant_config(name: str, base: Optional[HeatConfig] = None) -> HeatConfig:
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}; choose from {sorted(VARIANTS)}")
    base = base or HeatConfig()
    return base.with_(**VARIANTS[name])
