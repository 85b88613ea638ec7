"""Simulation façade: bind a force backend to an integrator (PyTorch).

The counterpart of `spacetpu/sim.py`, for the direct all-pairs solver, the
Barnes-Hut tree and the two mesh families, particle-mesh ("pm") and TreePM
("treepm"):

  sim = make_simulation(n)            # on the card by default
  state = sim.prime(state)            # calibrate if needed, fill the acc cache
  state = sim.step(state, dt)         # one tick
  state = sim.run(state, dt, steps)   # a Python loop of step

``algorithm="auto"`` picks the tree above `BARNES_HUT_CUTOFF` bodies, as
the reference does. Backends: "cuda" runs the hand-written kernels of
`ops/cuda_direct.py` and `ops/cuda_tree.py`, "torch" the plain PyTorch
solvers, and "auto" the first on the card and the second on the CPU. The
JAX names are accepted: "pallas" means "cuda" and "xla" means "torch".

Of the tree, this port runs two and three far-field levels, the
equal-count and the adaptive partition (and "auto", which measures both),
multipole orders 1 and 2, and the near phase as a pair list ("pairs", the
default with the kernels) or as strips ("strip", the default without
them; on the card through kernels of its own), with the near correction
summed directly or, with ``pallas_method="mxu"``, in the hybrid rank-1
form. The mesh families
calibrate at `prime`: the box and the FFT'd kernel (and for TreePM the
cutoff near-list caps) come from the primed state; a `step` before it
raises. With ``substeps`` m > 1 every solver but PM steps by the two-level
multirate leapfrog (`ops/multirate.py`), the fast set's passes on the
simulation's backend; `suggest_substeps` measures m and the fast set from
a primed state.

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
from spacetpu_torch.ops import cuda_direct, direct, integrators, multirate
from spacetpu_torch.ops import pm as pm_ops
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.ops import treepm as treepm_ops
from spacetpu_torch.state import State, resolve_device

ALGORITHMS = ("auto", "direct", "tree", "pm", "treepm")
BACKENDS = ("auto", "cuda", "torch")
_BACKEND_ALIASES = {"pallas": "cuda", "xla": "torch"}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The fields of `spacetpu.sim.SimConfig`, so that callers construct it
    unchanged."""

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

    def resolved_fast_cap(self) -> int:
        """The multirate fast-set capacity: "auto" is about N/8, a multiple
        of 128 and at least 128, never above N."""
        if self.fast_cap == "auto":
            return min(self.n, max(128, -(-(self.n // 8) // 128) * 128))
        return min(self.n, int(self.fast_cap))

    def resolved_leaf(self) -> int:
        return tree_ops.LEAF if self.leaf == "auto" else int(self.leaf)

    def resolved_cluster_mode(self) -> str:
        """ "auto" starts from "equal"; `Simulation.calibrate` upgrades it
        to "adaptive" where the near lists are heavy-tailed and the adaptive
        partition measurably shrinks the near work."""
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

    def resolved_pm_grid(self) -> int:
        """The mesh size: "auto" is TreePM's finer grid (~2 N^(1/3), its
        accuracy comes from the split) or PM's (~N^(1/3))."""
        if self.pm_grid == "auto":
            if self.resolved_algorithm() == "treepm":
                return treepm_ops.default_grid(self.n)
            return pm_ops.default_grid(self.n)
        return int(self.pm_grid)

    def resolved_split(self) -> tuple[float, float]:
        """(rs_cells, rcut_rs) of the TreePM force split."""
        rs_cells = (treepm_ops.RS_CELLS if self.pm_rs_cells is None
                    else float(self.pm_rs_cells))
        rcut_rs = (treepm_ops.RCUT_RS if self.pm_rcut_rs is None
                   else float(self.pm_rcut_rs))
        return rs_cells, rcut_rs

    def resolved_treepm_split(self) -> str:
        split = (treepm_ops.SPLIT if self.pm_split is None
                 else str(self.pm_split))
        if split not in ("poly", "gauss"):
            raise ValueError(f"unknown treepm split {split!r}")
        return split


class Simulation:
    """A bound (force backend, integrator) pair on one device."""

    def __init__(self, config: SimConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        algo = config.resolved_algorithm()
        if algo not in ALGORITHMS[1:]:
            raise ValueError(f"unknown algorithm {algo!r}")
        if config.substeps > 1 and config.integrator != "leapfrog":
            raise ValueError(
                "substeps > 1 is a leapfrog composition "
                f"(got integrator={config.integrator!r})")
        if config.substeps > 1 and algo == "pm":
            raise ValueError(
                "substeps > 1 is unsupported with algorithm='pm': the "
                "multirate fast-set substeps use exact pair forces, which "
                "are inconsistent with the mesh-softened PM force law")
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
        #: measured static sizes (calibrate()): the cluster-count cap of
        #: the adaptive partition, the capacities of the pair-list tile
        #: lists, the supercluster screen cap and the caps of the MID far
        #: field; None = worst-case defaults.
        self._gg: int | None = None
        self._near_tiles: int | None = None
        self._near_tiles_q: int | None = None
        self._k_super: int | None = None
        self._k_mid: int | None = None
        self._m1_src: int | None = None
        self._m2_src: int | None = None
        #: the partition calibrate() settled on (None before it ran)
        self._cluster_mode: str | None = None
        #: "tree-dense-near" when the measured near cap covers about all
        #: clusters: the caps are valid, but the near phase costs as much
        #: as all pairs and a caller that can switch solvers should.
        self.degenerate: str | None = None
        self._recal_exhausted = False
        #: the mesh calibration (pm, treepm): box_min, h, grid, kernel_hat,
        #: and for TreePM rs, rcut, split; None before `calibrate`
        self._pm: dict | None = None
        self._jit_consts: dict = {}
        # the mesh families always calibrate: their box and kernel come from
        # the primed state
        self._needs_calibration = algo in ("pm", "treepm")
        if algo == "treepm":
            config.resolved_treepm_split()
        if algo == "tree":
            self._check_tree_config()
            # the pair list and the adaptive partition want measured
            # capacities (they run with worst-case caps otherwise);
            # k_near="auto" always calibrates
            self._needs_calibration = (
                config.k_near == "auto"
                or config.resolved_near_mode(self.backend) == "pairs"
                or config.resolved_cluster_mode() == "adaptive")
        #: bumped by every calibration; callers of `spacetpu` pass it along
        #: with traced_step to learn that the caps changed
        self.jit_epoch: int = 1
        self.acc_fn = _build_acc_fn(config, self.backend, self._k_near)
        self._stepper = self._make_stepper()

    def _make_stepper(self):
        """Plain stepping by the configured integrator, or with substeps > 1
        the two-level multirate leapfrog (`ops/multirate.py`), whose fast
        set's passes run on this simulation's backend."""
        cfg = self.config
        if cfg.substeps <= 1:
            return integrators.get_stepper(cfg.integrator)
        kw = dict(substeps=cfg.substeps, fast_cap=cfg.resolved_fast_cap(),
                  softening=cfg.softening, eps=cfg.resolved_eps(), g=cfg.g,
                  backend=self.backend)

        def stepper(state, dt, acc_fn):
            return multirate.step_multirate(state, dt, acc_fn, **kw)

        return stepper

    def _check_tree_config(self):
        """Refuse an unknown partition or near mode."""
        cfg = self.config
        if cfg.cluster_mode not in ("auto", "equal", "adaptive"):
            raise ValueError(f"unknown cluster_mode {cfg.cluster_mode!r}")
        if cfg.resolved_near_mode(self.backend) not in ("strip", "pairs"):
            raise ValueError(f"unknown near_mode {cfg.near_mode!r}")

    @property
    def jit_consts(self) -> dict:
        """The mesh solvers' large constants (kernel_hat, box_min), as the
        JAX package threads them through its jitted programs; {} for the
        other solvers and before calibration. Nothing here needs them
        passed: `traced_step` accepts and ignores them."""
        return dict(self._jit_consts)

    @property
    def mesh_params(self) -> dict | None:
        """The mesh calibration (box_min, h, grid, kernel_hat; TreePM adds
        rs, rcut and split), a snapshot; None before calibration and for
        the pair solvers."""
        return dict(self._pm) if self._pm else None

    @property
    def caps(self) -> dict:
        """What calibrate() measured (a snapshot). A value of None does not
        apply to the solver or partition, or is still its worst-case
        default: ``gg`` is the adaptive partition's cluster cap, ``k_mid``
        and the ``m*_src_tiles`` are the caps of the pair-mode 3-level far
        field."""
        return {
            "k_near": self._k_near,
            "gg": self._gg,
            "near_tiles": self._near_tiles,
            "near_tiles_q": self._near_tiles_q,
            "k_super": self._k_super,
            "k_mid": self._k_mid,
            "m1_src_tiles": self._m1_src,
            "m2_src_tiles": self._m2_src,
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
        cached = r > 1 and self.algorithm in ("tree", "treepm")
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
        cmode = self._cluster_mode or cfg.resolved_cluster_mode()
        gg = self._gg or tree_ops._gg_for(cfg.n, cfg.far_levels, order, leaf,
                                          cmode)
        return dict(
            eps=cfg.resolved_eps(), order=order, leaf=leaf, cmode=cmode,
            gg=gg,
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
            far_levels=p["far_levels"], leaf=p["leaf"],
            cluster_mode=p["cmode"], near_mode=p["nmode"],
            near_tiles=self._near_tiles, near_tiles_q=self._near_tiles_q,
            k_super=self._k_super, k_mid=self._k_mid,
            m1_src_tiles=self._m1_src, m2_src_tiles=self._m2_src)

    def _mesh(self) -> dict:
        if self._pm is None:
            raise RuntimeError(
                f"{self.algorithm} solver is uncalibrated: call prime() (or "
                "calibrate()) first; the mesh box and kernel are measured "
                "from the first state")
        return self._pm

    def build_structure(self, state: State) -> dict:
        """The cacheable part of tree construction (`tree_structure`, or
        `treepm_structure` for TreePM) with this simulation's calibrated
        caps. Public with `step_cached`, as in `spacetpu`, whose engine loop
        calls the pair to rebuild the structure every few ticks."""
        if self.algorithm == "treepm":
            return treepm_ops.treepm_structure(
                state.pos, state.mass, rcut=self._mesh()["rcut"],
                k_near=self._k_near, gg=self._gg,
                leaf=self.config.resolved_leaf(),
                near_tiles=self._near_tiles)
        return tree_ops.tree_structure(state.pos, state.mass,
                                       **self._prep_kw())

    def step_cached(self, state: State, structure: dict, dt) -> State:
        """One tick against a cached tree or TreePM structure."""
        self._check(state)
        if self.algorithm == "treepm":
            return self._stepper(state, dt, self._treepm_acc(structure))
        p = self._tree_params()
        acc_fn = functools.partial(
            tree_ops.acc_tree_cached, structure=structure,
            softening=self.config.softening, eps=p["eps"], g=self.config.g,
            backend=self.backend, multipole_order=p["order"],
            far_levels=p["far_levels"], near_mode=p["nmode"],
            pairs_accum=self.config.pallas_method)
        return self._stepper(state, dt, acc_fn)

    def calibrate(self, state: State):
        """Measure the scene's near-list shape (`tree_ops.measure_near`) and
        rebuild the force closure with measured caps: the near-list cap
        (unless k_near is an explicit integer), the pair-list tile
        capacities, the supercluster screen cap, the caps of the pair-mode
        3-level far field and, for the adaptive partition, the cluster
        count. Equal-count clusters in high-density-contrast scenes need
        far larger caps than the geometric default. Waits for the device.
        Nothing to do for the direct solver.

        cluster_mode="auto": where the measured near lists are heavy-tailed
        (mean near count beyond 4x the geometric estimate, or half the
        clusters), the adaptive partition is measured too and taken if it
        needs under 0.8x the near tiles, as the JAX package does.

        The mesh families calibrate their mesh instead (`_calibrate_pm`,
        `_calibrate_treepm`)."""
        if self.algorithm == "pm":
            return self._calibrate_pm(state)
        if self.algorithm == "treepm":
            return self._calibrate_treepm(state)
        if self.algorithm != "tree":
            return
        cfg = self.config
        order = cfg.resolved_multipole_order()
        leaf = cfg.resolved_leaf()
        cmode = cfg.resolved_cluster_mode()
        gg = tree_ops._gg_for(cfg.n, cfg.far_levels, order, leaf, cmode)

        def need_mid(g):
            # the MID far field's caps apply only to far_levels=3 in pair mode
            return (tree_ops.resolve_far_levels(cfg.far_levels, g, order) == 3
                    and cfg.resolved_near_mode(self.backend) == "pairs")

        def measure(g, mode, mid):
            return tree_ops.measure_near(state.pos, state.mass,
                                         theta=cfg.theta, gg=g, leaf=leaf,
                                         cluster_mode=mode, measure_mid=mid)

        m = measure(gg, cmode, need_mid(gg))
        if cfg.cluster_mode == "auto" and cmode == "equal":
            # Heavy-tailed near lists mean equal-count clusters in the
            # sparse tail span huge radii and are near everything: only then
            # is the adaptive partition worth its extra clusters. Measure it
            # and keep whichever needs fewer near tiles.
            pj = max(tree_ops.NEAR_TILE_J // (leaf + 1), 1)
            mean_near = m["near_tiles"] * pj / max(m["n_clusters"], 1)
            trigger = min(4.0 * tree_ops.default_k_near(cfg.theta, gg),
                          gg / 2)
            if mean_near > trigger:
                gg_a = tree_ops._gg_for(cfg.n, cfg.far_levels, order, leaf,
                                        "adaptive")
                # exploratory: only the tiles are compared
                m_a = measure(gg_a, "adaptive", False)
                if m_a["near_tiles"] < 0.8 * m["near_tiles"]:
                    cmode, gg, m = "adaptive", gg_a, m_a
        self._cluster_mode = cmode
        if cmode == "adaptive":
            # Shrink the worst-case cluster cap to the measured scene (+25%
            # for drift, SUPER-aligned; a rebuild that outgrows it falls
            # back to the equal split), then measure again at that cap: the
            # padding clusters of the first pass each claimed tiles, and the
            # supercluster geometry changes without them. Measure again too
            # where the winning pass skipped the MID caps that the closure
            # needs.
            gg_meas = min(gg, int(m["n_clusters"] * 1.25) + 8)
            gg_run = -(-gg_meas // tree_ops.SUPER) * tree_ops.SUPER
            if gg_run < gg or ("k_mid" not in m and need_mid(gg_run)):
                m = measure(gg_run, "adaptive", need_mid(gg_run))
            self._gg = gg_run
        else:
            # a recalibration may go back to "equal" after an adaptive pass:
            # the shrunk adaptive cap must not reach the equal partition
            self._gg = None
        if not isinstance(cfg.k_near, int):
            self._k_near = m["k_near"]
        self._near_tiles = m["near_tiles"]
        self._near_tiles_q = m["near_tiles_q"]
        self._k_super = m.get("k_super")
        self._k_mid = m.get("k_mid")
        self._m1_src = m.get("m1_src_tiles")
        self._m2_src = m.get("m2_src_tiles")
        # A measured near cap that covers about all clusters means the near
        # phase costs as much as all pairs: flag it and warn. An explicit
        # integer k_near bounds the near work by construction.
        self.degenerate = None
        gg_run = self._gg or gg
        if (gg_run >= 64 and not isinstance(cfg.k_near, int)
                and self._k_near >= gg_run // 2):
            self.degenerate = "tree-dense-near"
            warnings.warn(
                f"tree near lists saturate the scene: measured "
                f"k_near={self._k_near} covers about all {gg_run} clusters "
                f"at theta={cfg.theta} (the near phase costs as much as all "
                "pairs). Use a wider theta or the direct solver.",
                stacklevel=2)
        self.acc_fn = _build_acc_fn(
            cfg, self.backend, self._k_near, gg=self._gg,
            near_tiles=self._near_tiles, near_tiles_q=self._near_tiles_q,
            cluster_mode=cmode, k_super=self._k_super, k_mid=self._k_mid,
            m1_src_tiles=self._m1_src, m2_src_tiles=self._m2_src)
        self.jit_epoch += 1
        self._needs_calibration = False

    def _mesh_box(self, state: State, grid: int):
        """(box_min, h) of the primed state, and box_min as a tensor of the
        state's dtype on its device for the force closures."""
        box_min, h = pm_ops.measure_box(state.pos, grid=grid,
                                        margin=self.config.pm_margin)
        box_t = torch.as_tensor(box_min, dtype=state.pos.dtype,
                                device=state.pos.device)
        return box_min, h, box_t

    def _calibrate_pm(self, state: State):
        """Measure the scene's bounding box (margin-padded) and build the FFT'd
        kernel on the state's device: box_min, the cell size h and the
        kernel become constants of the rebuilt force closure. A re-run
        (`maybe_recalibrate`) re-measures the box around the evolved
        positions, which always converges: the new box covers every body."""
        cfg = self.config
        self.degenerate = None
        grid = cfg.resolved_pm_grid()
        box_min, h, box_t = self._mesh_box(state, grid)
        kernel_hat = pm_ops.pm_kernel_hat(
            grid, h, eps=cfg.resolved_eps(), g=cfg.g, dtype=state.pos.dtype,
            device=state.pos.device)
        self._pm = dict(box_min=box_min, h=h, grid=grid,
                        kernel_hat=kernel_hat)
        self._jit_consts = dict(kernel_hat=kernel_hat, box_min=box_t)
        self.acc_fn = functools.partial(
            pm_ops.acc_pm, kernel_hat=kernel_hat, box_min=box_t, h=h,
            grid=grid)
        self.jit_epoch += 1
        self._needs_calibration = False

    def _calibrate_treepm(self, state: State):
        """TreePM calibration: the PM box and the long-range kernel of the
        split (rs = pm_rs_cells * h, r_cut = pm_rcut_rs * rs), and the
        measured cutoff near-list caps of the short-range pair pass
        (`treepm.measure_near_rcut`). Warns where eps exceeds rs (the
        truncated short-range tail is no longer negligible) and where the
        cutoff lists cover about every cluster (``degenerate =
        "treepm-saturated"``)."""
        cfg = self.config
        grid = cfg.resolved_pm_grid()
        leaf = cfg.resolved_leaf()
        box_min, h, box_t = self._mesh_box(state, grid)
        rs_cells, rcut_rs = cfg.resolved_split()
        rs, rcut = treepm_ops.split_params(h, rs_cells=rs_cells,
                                           rcut_rs=rcut_rs)
        eps = cfg.resolved_eps()
        if eps > rs:
            warnings.warn(
                f"TreePM split scale rs={rs:.3g} is below the softening "
                f"eps={eps:.3g}: the short-range tail truncated at "
                f"r_cut={rcut:.3g} is no longer negligible (the "
                "Plummer-vs-Newton deviation extends past the cutoff). Use a "
                "coarser mesh (pm_grid), a larger pm_rs_cells, or a smaller "
                "eps.", stacklevel=2)
        split = cfg.resolved_treepm_split()
        kernel_hat = treepm_ops.make_kernel_hat(
            split, grid, h, rs, rcut, g=cfg.g, dtype=state.pos.dtype,
            device=state.pos.device)
        gg = -(-cfg.n // leaf)
        m = treepm_ops.measure_near_rcut(state.pos, state.mass, rcut=rcut,
                                         gg=gg, leaf=leaf)
        # an explicit integer k_near is pinned (overflow telemetry counts)
        self._k_near = (cfg.k_near if isinstance(cfg.k_near, int)
                        else m["k_near"])
        # gg >= 64: at toy scales the cutoff legitimately covers the box
        self.degenerate = None
        if gg >= 64 and self._k_near >= gg // 2:
            self.degenerate = "treepm-saturated"
            warnings.warn(
                f"TreePM short-range cutoff saturates the scene: the "
                f"measured near-list cap k_near={self._k_near} covers about "
                f"all {gg} clusters (r_cut={rcut:.3g} against a mass "
                "distribution concentrated well inside it, e.g. a Plummer "
                "core in an outlier-stretched box). The pair pass costs as "
                "much as all pairs: use the tree solver, or a finer mesh "
                "(pm_grid).", stacklevel=2)
        self._near_tiles = m["near_tiles"]
        self._gg = gg
        self._pm = dict(box_min=box_min, h=h, grid=grid,
                        kernel_hat=kernel_hat, rs=rs, rcut=rcut, split=split)
        self._jit_consts = dict(kernel_hat=kernel_hat, box_min=box_t)
        self.acc_fn = functools.partial(
            treepm_ops.acc_treepm, k_near=self._k_near, gg=gg, leaf=leaf,
            near_tiles=self._near_tiles, **self._treepm_kw())
        self.jit_epoch += 1
        self._needs_calibration = False

    def _treepm_kw(self) -> dict:
        """The keyword arguments that `acc_treepm` and `acc_treepm_cached`
        share for this simulation's calibration."""
        pm = self._mesh()
        cfg = self.config
        return dict(kernel_hat=pm["kernel_hat"],
                    box_min=self._jit_consts["box_min"], h=pm["h"],
                    grid=pm["grid"], rs=pm["rs"], rcut=pm["rcut"],
                    split=pm["split"], softening=cfg.softening,
                    eps=cfg.resolved_eps(), g=cfg.g, backend=self.backend,
                    pairs_accum=cfg.pallas_method)

    def _treepm_acc(self, structure: dict) -> Callable:
        return functools.partial(treepm_ops.acc_treepm_cached,
                                 structure=structure, **self._treepm_kw())

    def maybe_recalibrate(self, state: State, *, frac: float = 0.02) -> bool:
        """Re-measure the scene and rebuild the force closure iff the caps
        have degraded: the near-overflow count exceeds `frac` of the
        cluster count (tree, TreePM), or the out-of-box count exceeds
        `frac` of N (PM, TreePM; the fix is a re-measured box, which always
        converges). Caps are measured from one snapshot; a scene that
        restructures can outgrow them, and overflow then costs near-field
        accuracy cluster by cluster. Returns True when a calibration ran.
        Waits for the device."""
        if self.algorithm == "pm":
            if self.health(state).get("out_of_box", 0) <= frac * self.config.n:
                return False
            self.calibrate(state)
            return True
        if self.algorithm not in ("tree", "treepm") or self._recal_exhausted:
            return False

        def bad(h):
            return (h.get("out_of_box", 0) > frac * self.config.n
                    or h["near_overflow"] > frac * (h["clusters"] or 1))

        if not bad(self.health(state)):
            return False
        self.calibrate(state)
        # An explicit integer k_near is pinned, so overflow from a too-small
        # user cap cannot converge: stop re-triggering (TreePM, as in the
        # JAX package, only for a pinned cap).
        h2 = self.health(state)
        if (h2["near_overflow"] > frac * (h2["clusters"] or 1)
                and (self.algorithm == "tree"
                     or isinstance(self.config.k_near, int))):
            warnings.warn(
                "recalibration could not clear the near-list overflow "
                f"(k_near={self._k_near} is explicit and pinned); "
                "auto-recalibration disabled for this simulation",
                stacklevel=2)
            self._recal_exhausted = True
        return True

    def suggest_substeps(self, state: State, dt, *, eta: float = 0.02,
                         max_substeps: int = 64) -> tuple[int, int, str]:
        """(substeps, fast_cap, reason) for multirate stepping at outer step
        ``dt``, measured on the host (numpy, float64) from a primed state's
        cached acceleration.

        A body is resolved when its step is at most ``eta * tau`` (tau as
        `multirate.dynamical_time` ranks it). m is the least power of two
        that resolves the WORST body, at most `max_substeps`: multirate has
        one fast level, and a quantile misses the two bodies of a hard
        binary among 262,144. The fast capacity covers every unresolved
        body with 25% headroom, rounded up to 128. Returns (1, 0, "uniform")
        when every body is resolved at dt, (1, 0, "lower-dt") when the fast
        set would exceed N/4 (multirate would cost more than stepping
        finer), else (m, F, "multirate"). Reads the state back."""
        import numpy as np

        v = np.linalg.norm(state.vel.detach().cpu().numpy().astype(
            np.float64), axis=-1)
        a = np.linalg.norm(state.acc.detach().cpu().numpy().astype(
            np.float64), axis=-1)
        v_eff = v + 1e-3 * float(np.mean(v))
        tau = np.where((v == 0) & (a == 0), np.inf,
                       v_eff / np.maximum(a, 1e-300))
        if state.n_active is not None:
            tau = tau[: int(state.n_active)]
        need = float(dt) / (eta * np.maximum(tau, 1e-300))
        m = float(np.max(need))
        if m <= 1.0:
            return 1, 0, "uniform"
        m = min(1 << max(0, int(np.ceil(np.log2(m)))), max_substeps)
        raw = int(np.sum(need > 1.0) * 1.25)
        # the cost guard takes the raw count: the floor of 128 below would
        # veto small scenes whose fast work is negligible anyway
        if raw > self.config.n // 4:
            return 1, 0, "lower-dt"
        f = min(self.config.n, max(128, -(-raw // 128) * 128))
        return m, f, "multirate"

    def health(self, state: State) -> dict:
        """Telemetry under THIS simulation's partition and caps: the tree's
        near-list overflow; PM's count of bodies outside the calibrated box
        ({} before calibration); TreePM's both. Waits for the device."""
        if self.algorithm in ("pm", "treepm"):
            if self._pm is None:
                return {}
            pm = self._pm
            out = {"algorithm": self.algorithm,
                   "out_of_box": int(pm_ops.count_out_of_box(
                       state.pos, pm["box_min"], pm["h"], pm["grid"])),
                   "grid": pm["grid"]}
            if self.algorithm == "treepm":
                prep = treepm_ops.treepm_prep(
                    state.pos, state.mass, rcut=pm["rcut"],
                    k_near=self._k_near, gg=self._gg,
                    leaf=self.config.resolved_leaf(),
                    near_tiles=self._near_tiles)
                out.update(near_overflow=int(prep["near_overflow"]),
                           clusters=self._gg, k_near=self._k_near)
            return out
        if self.algorithm != "tree":
            return {"algorithm": self.algorithm}
        kw = self._prep_kw()
        prep = tree_ops.tree_prep(state.pos, state.mass, **kw)
        return {"algorithm": "tree",
                "near_overflow": int(prep["near_overflow"]),
                "clusters": kw["gg"], "k_near": kw["k_near"]}


def _build_acc_fn(config: SimConfig, backend: str,
                  k_near: int | None = None, *, gg: int | None = None,
                  near_tiles: int | None = None,
                  near_tiles_q: int | None = None,
                  cluster_mode: str | None = None,
                  k_super: int | None = None, k_mid: int | None = None,
                  m1_src_tiles: int | None = None,
                  m2_src_tiles: int | None = None) -> Callable:
    eps = config.resolved_eps()
    algo = config.resolved_algorithm()
    if algo in ("pm", "treepm"):
        # the real closure is built by Simulation._calibrate_pm /
        # _calibrate_treepm from the primed state's bounding box; this
        # placeholder catches a step() before prime() or calibrate()
        def _mesh_uncalibrated(pos, mass):
            raise RuntimeError(
                f"{algo} solver is uncalibrated: call prime() (or "
                "calibrate()) before step/run; the mesh box and FFT'd "
                "kernel are measured from the first state")

        return _mesh_uncalibrated
    if algo == "tree":
        return functools.partial(
            tree_ops.acc_tree, theta=config.theta,
            far_levels=config.far_levels, softening=config.softening,
            eps=eps, g=config.g, backend=backend,
            multipole_order=config.resolved_multipole_order(), k_near=k_near,
            leaf=config.resolved_leaf(),
            cluster_mode=cluster_mode or config.resolved_cluster_mode(),
            near_mode=config.resolved_near_mode(backend),
            near_tiles=near_tiles, near_tiles_q=near_tiles_q, gg=gg,
            k_super=k_super, k_mid=k_mid, m1_src_tiles=m1_src_tiles,
            m2_src_tiles=m2_src_tiles, pairs_accum=config.pallas_method)
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
