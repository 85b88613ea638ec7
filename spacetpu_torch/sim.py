"""Simulation façade: bind a force backend to an integrator (PyTorch).

The counterpart of `spacetpu/sim.py`, for the direct all-pairs solver and
the Barnes-Hut tree:

  sim = make_simulation(n)            # on the card by default
  state = sim.prime(state)            # calibrate if needed, fill the acc cache
  state = sim.step(state, dt)         # one tick
  state = sim.run(state, dt, steps)   # a Python loop of step

``algorithm="auto"`` picks the tree above `BARNES_HUT_CUTOFF` bodies, as
the reference does. Backends: "cuda" runs the hand-written kernels of
`ops/cuda_direct.py` and `ops/cuda_tree.py`, "torch" the plain PyTorch
solvers, and "auto" the first on the card and the second on the CPU. The
JAX names are accepted: "pallas" means "cuda" and "xla" means "torch".

Of the tree, this port runs two far-field levels, the equal-count
partition, multipole orders 1 and 2, and the near phase as a pair list
("pairs", the default with the kernels) or as strips ("strip", plain
PyTorch only, the default without them). What it leaves out raises
`NotImplementedError` naming its ROADMAP.md item.

`calibrate`, `maybe_recalibrate` and `health` read integers back from the
device and so wait for it; `prime` does when it calibrates. `step` and
`run` read nothing back (`run` waits once at its end when `progress` is
given).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable

import torch

from spacetpu_torch import constants
from spacetpu_torch.ops import cuda_direct, direct, integrators
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.state import State, resolve_device

ALGORITHMS = ("auto", "direct", "tree", "pm", "treepm")
BACKENDS = ("auto", "cuda", "torch")
_BACKEND_ALIASES = {"pallas": "cuda", "xla": "torch"}

#: ROADMAP.md items that port what this package leaves out.
_MESH = "ROADMAP.md Queue A item 8 (mesh families)"
_MULTIRATE = "ROADMAP.md Queue A item 9 (extra physics: multirate)"
_NOT_PORTED = {"pm": _MESH, "treepm": _MESH}
#: `caps["cluster_mode"]` where cluster_mode="auto" met heavy-tailed near
#: lists: the equal partition runs, the adaptive one was never measured
EQUAL_UNMEASURED = "equal (adaptive unmeasured)"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The fields of `spacetpu.sim.SimConfig`, so that callers construct it
    unchanged. The direct solver's and the tree's fields take effect; the
    mesh and multirate fields are kept for their later ports."""

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

    def resolved_leaf(self) -> int:
        return tree_ops.LEAF if self.leaf == "auto" else int(self.leaf)

    def resolved_cluster_mode(self) -> str:
        """ "auto" starts from "equal"; `Simulation.calibrate` checks
        whether the JAX package would go on to the adaptive partition."""
        return "equal" if self.cluster_mode == "auto" else self.cluster_mode

    def resolved_near_mode(self, backend: str) -> str:
        """ "auto": the pair list where the kernels run, strips on the plain
        path (whose pair-list versions loop over tiles)."""
        if self.near_mode != "auto":
            return self.near_mode
        return "pairs" if backend == "cuda" else "strip"

    def resolved_multipole_order(self) -> int:
        if self.multipole_order == "auto":
            return 2 if self.softening == "plummer" else 1
        return int(self.multipole_order)

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
            raise NotImplementedError(
                f"algorithm={algo!r} is not ported yet: {_NOT_PORTED[algo]}")
        if algo not in ("direct", "tree"):
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
        self.algorithm = algo
        self.backend = config.resolved_backend(self.device)
        if (algo == "direct" and config.pallas_method == "mxu"
                and self.backend == "cuda"
                and (config.softening != "plummer"
                     or config.resolved_eps() <= 0.0)):
            raise ValueError(
                "pallas_method='mxu' requires softening='plummer' with "
                "eps > 0: the expanded-form distances are cancellation "
                "noise on the diagonal, so a real softening floor is the "
                "self-pair guard (ops/cuda_direct.acc_cross_kernel)")
        #: resolved near-list cap (None = the geometric default);
        #: k_near="auto" is measured from the first primed state.
        self._k_near: int | None = (
            config.k_near if isinstance(config.k_near, int) else None)
        #: measured capacities of the pair-list tile lists and of the
        #: supercluster screen (calibrate()); None = worst-case defaults.
        self._near_tiles: int | None = None
        self._near_tiles_q: int | None = None
        self._k_super: int | None = None
        #: the partition calibrate() settled on (None before it ran)
        self._cluster_mode: str | None = None
        #: "tree-dense-near" when the measured near cap covers about all
        #: clusters: the caps are valid, but the near phase costs as much
        #: as all pairs and a caller that can switch solvers should.
        self.degenerate: str | None = None
        self._recal_exhausted = False
        self._needs_calibration = False
        if algo == "tree":
            self._check_tree_config()
            # the pair list wants measured capacities (it runs with
            # worst-case caps otherwise); k_near="auto" always calibrates
            self._needs_calibration = (
                config.k_near == "auto"
                or config.resolved_near_mode(self.backend) == "pairs")
        #: bumped by every calibration; callers of `spacetpu` pass it along
        #: with traced_step to learn that the caps changed
        self.jit_epoch: int = 1
        self.acc_fn = _build_acc_fn(config, self.backend, self._k_near)
        self._stepper = integrators.get_stepper(config.integrator)

    def _check_tree_config(self):
        """Refuse, by name, what the tree's port leaves out."""
        cfg = self.config
        if cfg.pallas_method == "mxu":
            raise NotImplementedError(
                "pallas_method='mxu' with the tree (the hybrid pair "
                f"accumulation) is not ported yet: {tree_ops._HYBRID}")
        if cfg.cluster_mode == "adaptive":
            raise NotImplementedError(
                "cluster_mode='adaptive' is not ported yet: "
                f"{tree_ops._ADAPTIVE}; pass cluster_mode='equal'")
        if cfg.cluster_mode not in ("auto", "equal"):
            raise ValueError(f"unknown cluster_mode {cfg.cluster_mode!r}")
        near_mode = cfg.resolved_near_mode(self.backend)
        if near_mode not in ("strip", "pairs"):
            raise ValueError(f"unknown near_mode {cfg.near_mode!r}")
        if near_mode == "strip" and self.backend == "cuda":
            raise NotImplementedError(
                f"near_mode='strip' has no kernels yet: {tree_ops._STRIP}; "
                "use near_mode='pairs' or backend='torch'")
        p = self._tree_params()
        if p["far_levels"] == 3:
            how = (f" (far_levels='auto' picks it at {tree_ops.FAR3_CUTOFF} "
                   f"clusters and above; n={cfg.n} at leaf={p['leaf']} has "
                   f"{p['gg']})" if cfg.far_levels == "auto" else "")
            raise NotImplementedError(
                f"far_levels=3 is not ported yet{how}: {tree_ops._FAR3}; "
                "pass far_levels=2")

    @property
    def jit_consts(self) -> dict:
        """Large constants of mesh solvers; none for direct and tree."""
        return {}

    @property
    def caps(self) -> dict:
        """What calibrate() measured (a snapshot). A value of None does not
        apply to the solver, or is still its worst-case default. ``gg``,
        ``k_mid`` and the ``m*_src_tiles`` belong to the adaptive partition
        and the 3-level far field and stay None."""
        return {
            "k_near": self._k_near,
            "gg": None,
            "near_tiles": self._near_tiles,
            "near_tiles_q": self._near_tiles_q,
            "k_super": self._k_super,
            "k_mid": None,
            "m1_src_tiles": None,
            "m2_src_tiles": None,
            "cluster_mode": self._cluster_mode,
        }

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
        if self._needs_calibration:
            self.calibrate(state)
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
        """Roll out `steps` ticks. With the tree and tree_refresh_every =
        r > 1, the sort and the near lists are rebuilt every r steps and
        reused in between (cluster statistics always follow the current
        positions). `progress`, if given, is called with `steps` once the
        device has finished them."""
        r = self.config.tree_refresh_every
        cached = r > 1 and self.algorithm == "tree"
        structure = None
        for k in range(steps):
            if cached:
                if k % r == 0:
                    structure = self.build_structure(state)
                state = self.step_cached(state, structure, dt)
            else:
                state = self.step(state, dt)
        if progress is not None:
            if state.pos.is_cuda:
                torch.cuda.synchronize(state.pos.device)
            progress(steps)
        return state

    def _tree_params(self) -> dict:
        """Resolved and calibrated tree parameters shared by the force
        closure, the cached-structure path and health()."""
        cfg = self.config
        order = cfg.resolved_multipole_order()
        leaf = cfg.resolved_leaf()
        gg = tree_ops._gg_for(cfg.n, cfg.far_levels, order, leaf, "equal")
        return dict(
            eps=cfg.resolved_eps(), order=order, leaf=leaf, gg=gg,
            far_levels=tree_ops.resolve_far_levels(cfg.far_levels, gg,
                                                   order),
            k_near=self._k_near or tree_ops.default_k_near(cfg.theta, gg),
            nmode=cfg.resolved_near_mode(self.backend))

    def _prep_kw(self) -> dict:
        """The keyword arguments of `tree_ops.tree_prep` for this
        simulation's calibrated caps."""
        p = self._tree_params()
        return dict(
            theta=self.config.theta, k_near=p["k_near"], gg=p["gg"],
            far_levels=p["far_levels"], leaf=p["leaf"], cluster_mode="equal",
            near_mode=p["nmode"], near_tiles=self._near_tiles,
            near_tiles_q=self._near_tiles_q, k_super=self._k_super)

    def build_structure(self, state: State) -> dict:
        """The cacheable part of tree construction (`tree_structure`) with
        this simulation's calibrated caps. Public with `step_cached`, as in
        `spacetpu`, whose engine loop calls the pair to rebuild the
        structure every few ticks."""
        return tree_ops.tree_structure(state.pos, state.mass,
                                       **self._prep_kw())

    def step_cached(self, state: State, structure: dict, dt) -> State:
        """One tick against a cached tree structure."""
        self._check(state)
        p = self._tree_params()
        acc_fn = functools.partial(
            tree_ops.acc_tree_cached, structure=structure,
            softening=self.config.softening, eps=p["eps"], g=self.config.g,
            backend=self.backend, multipole_order=p["order"],
            far_levels=p["far_levels"], near_mode=p["nmode"])
        return self._stepper(state, dt, acc_fn)

    def calibrate(self, state: State):
        """Measure the scene's near-list shape (`tree_ops.measure_near`) and
        rebuild the force closure with measured caps: the near-list cap
        (unless k_near is an explicit integer), the pair-list tile
        capacities and the supercluster screen cap. Equal-count clusters in
        high-density-contrast scenes need far larger caps than the
        geometric default. Waits for the device. Nothing to do for the
        direct solver.

        cluster_mode="auto": where the measured near lists are heavy-tailed
        (mean near count beyond 4x the geometric estimate, or half the
        clusters), the JAX package goes on to measure the adaptive
        partition and takes it if it needs under 0.8x the tiles. That
        partition is not ported, so this warns, stays with the equal
        partition, and reports ``caps["cluster_mode"]`` as
        `EQUAL_UNMEASURED` instead of "equal", so that a caller can tell a
        partition that was chosen from one that was all there is."""
        if self.algorithm != "tree":
            return
        cfg = self.config
        p = self._tree_params()
        gg, leaf = p["gg"], p["leaf"]
        m = tree_ops.measure_near(state.pos, state.mass, theta=cfg.theta,
                                  gg=gg, leaf=leaf, cluster_mode="equal")
        self._cluster_mode = "equal"
        if cfg.cluster_mode == "auto":
            pj = max(tree_ops.NEAR_TILE_J // (leaf + 1), 1)
            mean_near = m["near_tiles"] * pj / max(m["n_clusters"], 1)
            trigger = min(4.0 * tree_ops.default_k_near(cfg.theta, gg),
                          gg / 2)
            if mean_near > trigger:
                warnings.warn(
                    f"cluster_mode='auto': the near lists are heavy-tailed "
                    f"(mean near count {mean_near:.0f} > {trigger:.0f}); the "
                    "adaptive partition that would be measured next is not "
                    f"ported yet ({tree_ops._ADAPTIVE}), so the equal "
                    "partition stays. Pass cluster_mode='equal' to say so.",
                    stacklevel=2)
                self._cluster_mode = EQUAL_UNMEASURED
        if not isinstance(cfg.k_near, int):
            self._k_near = m["k_near"]
        self._near_tiles = m["near_tiles"]
        self._near_tiles_q = m["near_tiles_q"]
        self._k_super = m["k_super"]
        # A measured near cap that covers about all clusters means the near
        # phase costs as much as all pairs: flag it and warn. An explicit
        # integer k_near bounds the near work by construction.
        self.degenerate = None
        if (gg >= 64 and not isinstance(cfg.k_near, int)
                and self._k_near >= gg // 2):
            self.degenerate = "tree-dense-near"
            warnings.warn(
                f"tree near lists saturate the scene: measured "
                f"k_near={self._k_near} covers about all {gg} clusters at "
                f"theta={cfg.theta} (the near phase costs as much as all "
                "pairs). Use a wider theta or the direct solver.",
                stacklevel=2)
        self.acc_fn = _build_acc_fn(
            cfg, self.backend, self._k_near, near_tiles=self._near_tiles,
            near_tiles_q=self._near_tiles_q, k_super=self._k_super)
        self.jit_epoch += 1
        self._needs_calibration = False

    def maybe_recalibrate(self, state: State, *, frac: float = 0.02) -> bool:
        """Re-measure the scene and rebuild the force closure iff the caps
        have degraded: the near-overflow count exceeds `frac` of the
        cluster count. Caps are measured from one snapshot; a scene that
        restructures can outgrow them, and overflow then costs near-field
        accuracy cluster by cluster. Returns True when a calibration ran.
        Waits for the device."""
        if self.algorithm != "tree" or self._recal_exhausted:
            return False
        h = self.health(state)
        if h["near_overflow"] <= frac * (h["clusters"] or 1):
            return False
        self.calibrate(state)
        # An explicit integer k_near is pinned, so overflow from a too-small
        # user cap cannot converge: stop re-triggering.
        h2 = self.health(state)
        if h2["near_overflow"] > frac * (h2["clusters"] or 1):
            warnings.warn(
                "recalibration could not clear the near-list overflow "
                f"(k_near={self._k_near} is explicit and pinned); "
                "auto-recalibration disabled for this simulation",
                stacklevel=2)
            self._recal_exhausted = True
        return True

    def health(self, state: State) -> dict:
        """Tree telemetry: the near-list overflow count under THIS
        simulation's partition and caps. Waits for the device."""
        if self.algorithm != "tree":
            return {"algorithm": self.algorithm}
        kw = self._prep_kw()
        prep = tree_ops.tree_prep(state.pos, state.mass, **kw)
        return {"algorithm": "tree",
                "near_overflow": int(prep["near_overflow"]),
                "clusters": kw["gg"], "k_near": kw["k_near"]}


def _build_acc_fn(config: SimConfig, backend: str,
                  k_near: int | None = None, *,
                  near_tiles: int | None = None,
                  near_tiles_q: int | None = None,
                  k_super: int | None = None) -> Callable:
    eps = config.resolved_eps()
    if config.resolved_algorithm() == "tree":
        return functools.partial(
            tree_ops.acc_tree, theta=config.theta,
            far_levels=config.far_levels, softening=config.softening,
            eps=eps, g=config.g, backend=backend,
            multipole_order=config.resolved_multipole_order(), k_near=k_near,
            leaf=config.resolved_leaf(), cluster_mode="equal",
            near_mode=config.resolved_near_mode(backend),
            near_tiles=near_tiles, near_tiles_q=near_tiles_q,
            k_super=k_super, pairs_accum=config.pallas_method)
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
