"""Simulation façade: bind a force backend to an integrator (PyTorch).

The counterpart of `spacetpu/sim.py`, for the direct all-pairs solver:

  sim = make_simulation(n, algorithm="direct")     # on the card by default
  state = sim.prime(state)            # populate the acc cache
  state = sim.step(state, dt)         # one tick
  state = sim.run(state, dt, steps)   # a Python loop of step

Backends: "cuda" runs the hand-written kernels of `ops/cuda_direct.py`,
"torch" the plain PyTorch solver of `ops/direct.py`, and "auto" the first
on the card and the second on the CPU. The JAX names are accepted:
"pallas" means "cuda" and "xla" means "torch".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from spacetpu_torch import constants
from spacetpu_torch.ops import cuda_direct, direct, integrators
from spacetpu_torch.state import State, resolve_device

ALGORITHMS = ("auto", "direct", "tree", "pm", "treepm")
BACKENDS = ("auto", "cuda", "torch")
_BACKEND_ALIASES = {"pallas": "cuda", "xla": "torch"}

#: ROADMAP.md items that port what this slice leaves out.
_TREE = "ROADMAP.md Queue A item 6 (tree)"
_MESH = "ROADMAP.md Queue A item 8 (mesh families)"
_MULTIRATE = "ROADMAP.md Queue A item 9 (extra physics: multirate)"
_NOT_PORTED = {"tree": _TREE, "pm": _MESH, "treepm": _MESH}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The fields of `spacetpu.sim.SimConfig`, so that callers construct it
    unchanged. Only the direct solver's fields take effect in this port;
    the tree, mesh and multirate fields are kept for their later ports."""

    n: int
    algorithm: str = "auto"  # direct | tree | pm | treepm | auto (N-based)
    backend: str = "auto"  # cuda | torch | auto (device-based)
    integrator: str = "leapfrog"  # leapfrog | euler (ref-compatible) | yoshida4
    softening: str = "plummer"  # plummer | ref (reference-compatible)
    eps: float | None = None  # None -> COLLISION_EPSILON for "ref", 0 for plummer
    g: float = constants.G
    theta: float = constants.BARNES_HUT_THETA
    chunk: int | None = None  # target chunk of the plain path (None = dense)
    # direct-solver kernel: "vpu" (exact pairwise differences) or "mxu"
    # (expanded-form distances; plummer softening with eps > 0 only)
    pallas_method: str = "vpu"
    multipole_order: object = "auto"
    k_near: object = None
    tree_refresh_every: int = 1
    leaf: object = "auto"
    cluster_mode: str = "auto"
    far_levels: object = "auto"
    near_mode: str = "auto"
    run_chunk: int | None = None
    substeps: int = 1
    fast_cap: object = "auto"
    pm_grid: object = "auto"
    pm_margin: float = 2.0
    pm_rs_cells: float | None = None
    pm_rcut_rs: float | None = None
    pm_split: str | None = None

    def resolved_algorithm(self) -> str:
        if self.algorithm != "auto":
            return self.algorithm
        # the reference's cutoff: tree iff N > BARNES_HUT_CUTOFF
        return "tree" if self.n > constants.BARNES_HUT_CUTOFF else "direct"

    def resolved_backend(self, device) -> str:
        """The backend for a simulation on `device`."""
        backend = _BACKEND_ALIASES.get(self.backend, self.backend)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(want one of {BACKENDS})")
        if backend == "auto":
            return "cuda" if torch.device(device).type == "cuda" else "torch"
        return backend

    def resolved_eps(self) -> float:
        if self.eps is not None:
            return self.eps
        return constants.COLLISION_EPSILON if self.softening == "ref" else 0.0


class Simulation:
    """A bound (force backend, integrator) pair on one device."""

    def __init__(self, config: SimConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        algo = config.resolved_algorithm()
        if algo in _NOT_PORTED:
            how = (f" (algorithm='auto' picks it above BARNES_HUT_CUTOFF="
                   f"{constants.BARNES_HUT_CUTOFF} bodies; pass "
                   "algorithm='direct')" if config.algorithm == "auto" else "")
            raise NotImplementedError(
                f"algorithm={algo!r} is not ported yet{how}: "
                f"{_NOT_PORTED[algo]}")
        if algo != "direct":
            raise ValueError(f"unknown algorithm {algo!r}")
        if config.substeps > 1:
            raise NotImplementedError(
                f"substeps > 1 (multirate) is not ported yet: {_MULTIRATE}")
        if config.softening not in direct.SOFTENINGS:
            raise ValueError(f"unknown softening {config.softening!r} "
                             f"(want one of {direct.SOFTENINGS})")
        if config.pallas_method not in ("vpu", "mxu"):
            raise ValueError(f"unknown pallas_method {config.pallas_method!r}"
                             " (want 'vpu' or 'mxu')")
        self.backend = config.resolved_backend(self.device)
        if (config.pallas_method == "mxu" and self.backend == "cuda"
                and (config.softening != "plummer"
                     or config.resolved_eps() <= 0.0)):
            raise ValueError(
                "pallas_method='mxu' requires softening='plummer' with "
                "eps > 0: the expanded-form distances are cancellation "
                "noise on the diagonal, so a real softening floor is the "
                "self-pair guard (ops/cuda_direct.acc_cross_kernel)")
        #: there is no compiled program to re-trace; kept for callers of
        #: `spacetpu` that pass it along with traced_step
        self.jit_epoch: int = 1
        self.acc_fn = _build_acc_fn(config, self.backend)
        self._stepper = integrators.get_stepper(config.integrator)

    @property
    def jit_consts(self) -> dict:
        """Large constants of mesh solvers; none for the direct solver."""
        return {}

    @property
    def caps(self) -> dict:
        """Calibration caps of the tree solvers; all None for direct."""
        return dict.fromkeys(
            ("k_near", "gg", "near_tiles", "near_tiles_q", "k_super",
             "k_mid", "m1_src_tiles", "m2_src_tiles", "cluster_mode"))

    def _check(self, state: State):
        if state.pos.shape[0] != self.config.n:
            raise ValueError(
                f"state has {state.pos.shape[0]} bodies but this Simulation "
                f"was built for n={self.config.n}")
        if state.pos.device.type != self.device.type:
            raise ValueError(
                f"state is on {state.pos.device} but this Simulation runs on "
                f"{self.device}")

    def prime(self, state: State) -> State:
        self._check(state)
        return integrators.prime(state, self.acc_fn)

    def step(self, state: State, dt) -> State:
        self._check(state)
        return self._stepper(state, dt, self.acc_fn)

    def traced_step(self, state: State, dt, consts) -> State:
        """One step; `consts` (from :attr:`jit_consts`) is accepted for
        parity with `spacetpu` and unused."""
        del consts
        return self.step(state, dt)

    def run(self, state: State, dt, steps: int, *,
            progress: Callable | None = None) -> State:
        """Roll out `steps` ticks. `progress`, if given, is called with
        `steps` once the device has finished them."""
        for _ in range(steps):
            state = self.step(state, dt)
        if progress is not None:
            if state.pos.is_cuda:
                torch.cuda.synchronize(state.pos.device)
            progress(steps)
        return state

    def calibrate(self, state: State):
        raise NotImplementedError(
            f"calibrate() serves the tree and mesh solvers: {_TREE}")

    def maybe_recalibrate(self, state: State, *, frac: float = 0.02) -> bool:
        raise NotImplementedError(
            f"maybe_recalibrate() serves the tree and mesh solvers: {_TREE}")

    def health(self, state: State) -> dict:
        raise NotImplementedError(
            f"health() reports tree and mesh telemetry: {_TREE}")


def _build_acc_fn(config: SimConfig, backend: str) -> Callable:
    eps = config.resolved_eps()
    if backend == "cuda":
        return functools.partial(
            cuda_direct.acc_direct_kernel, softening=config.softening,
            eps=eps, g=config.g, method=config.pallas_method)
    if config.chunk:
        return functools.partial(
            direct.acc_direct_chunked, softening=config.softening, eps=eps,
            g=config.g, chunk=config.chunk)
    return functools.partial(
        direct.acc_direct, softening=config.softening, eps=eps, g=config.g)


def make_simulation(
    n: int,
    *,
    algorithm: str = "auto",
    backend: str = "auto",
    integrator: str = "leapfrog",
    softening: str = "plummer",
    eps: float | None = None,
    g: float = constants.G,
    theta: float = constants.BARNES_HUT_THETA,
    chunk: int | None = None,
    multipole_order="auto",
    tree_refresh_every: int = 1,
    k_near=None,
    leaf="auto",
    cluster_mode: str = "auto",
    near_mode: str = "auto",
    far_levels="auto",
    run_chunk: int | None = None,
    substeps: int = 1,
    fast_cap="auto",
    pm_grid="auto",
    pm_margin: float = 2.0,
    pm_rs_cells: float | None = None,
    pm_rcut_rs: float | None = None,
    pm_split: str | None = None,
    pallas_method: str = "vpu",
    device=None,
) -> Simulation:
    """The keyword arguments of `spacetpu.make_simulation`, plus `device`
    (default: the card; raises when there is none)."""
    return Simulation(
        SimConfig(
            n=n,
            algorithm=algorithm,
            backend=backend,
            integrator=integrator,
            softening=softening,
            eps=eps,
            g=g,
            theta=theta,
            chunk=chunk,
            multipole_order=multipole_order,
            tree_refresh_every=tree_refresh_every or 1,
            k_near=k_near,
            leaf=leaf,
            cluster_mode=cluster_mode,
            near_mode=near_mode,
            far_levels=far_levels,
            run_chunk=run_chunk,
            substeps=substeps,
            fast_cap=fast_cap,
            pm_grid=pm_grid,
            pm_margin=pm_margin,
            pm_rs_cells=pm_rs_cells,
            pm_rcut_rs=pm_rcut_rs,
            pm_split=pm_split,
            pallas_method=pallas_method,
        ),
        device=device,
    )


def reference_compatible(n: int, **kw) -> Simulation:
    """A Simulation reproducing the reference force law and integrator:
    semi-implicit Euler with additive-eps softening. The backend defaults
    to "auto", so on the card it runs the kernel too."""
    kw.setdefault("algorithm", "direct")
    kw.setdefault("backend", "auto")
    return make_simulation(n, integrator="euler", softening="ref", **kw)
