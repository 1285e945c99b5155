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
