"""Asynchronous simulation engine: the sim thread and the UI thread.

The counterpart of `spacetpu/engine.py`. A sim thread runs the tick loop
(`run_sim_loop`: `check_interval` ticks a batch, a snapshot when the UI
asked for one, dt re-read every batch, exit on the stop token) and an
`Exchange` carries snapshots, the tick count and the live dt between it and
the frontends. `make_engine_for` picks the solver from the scene
(`select_solver`: direct, tree, or on large resolvable scenes PM) and wires
the mid-run fallback of the mesh tiers to the tree (`_recheck_solver`).

On the card both threads issue work to PyTorch's current stream, which
runs it in issue order. A snapshot is an on-device copy of the positions
(a new buffer, so later steps cannot change it), copied without blocking
into pinned host memory behind a CUDA event (`_snapshot_begin`); the
consumer's `sample()` waits on that event (`_snapshot_finish`). So the sim
thread never waits for a frontend's readback, and a frontend waits only for
the work queued before its own snapshot.

Two locks keep the JAX package's names:

- `DEVICE_LOCK` serializes the host-side issue of device work between the
  threads: a batch of steps with its solver re-check and snapshot, and a
  frontend's trail update and frame. It guards the host objects those
  touch (the `Simulation`'s calibration, which a re-check may rebuild, and
  the frontend's trail buffer) and keeps each one's launches contiguous on
  the stream. It is held for issue only, never across a wait for the card.
- `TRANSFER_LOCK` serializes the waits on device-to-host readbacks: a
  snapshot's, a frame's (`render.viewer`), and the sim loop's queue bound.
  Every host readback outside `DEVICE_LOCK` takes it; the order is
  `DEVICE_LOCK` then `TRANSFER_LOCK`, never the reverse. With it, any
  number of consumers may sample and render at once.

Two defects of the JAX version are fixed here: `Exchange.store` never
moves `current_ticks()` back (the JAX version assigns the tick, while
`note_ticks` takes a maximum), and a frame's readback waits under
`TRANSFER_LOCK` outside `DEVICE_LOCK`, like a snapshot's, so concurrent
consumers are safe (the JAX viewer reads back under `DEVICE_LOCK` alone).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from spacetpu_torch import constants
from spacetpu_torch.sim import Simulation, make_simulation
from spacetpu_torch.state import State

DEVICE_LOCK = threading.RLock()
TRANSFER_LOCK = threading.Lock()


def _host(x) -> np.ndarray:
    """A tensor or array-like as a host numpy array (waits for the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Readback:
    """A device-to-host copy in flight: `arrays` are pinned host tensors
    (plain CPU tensors off the card) that hold their values once `event`
    (None off the card) has completed."""

    def __init__(self, *tensors: torch.Tensor):
        if tensors[0].device.type != "cuda":
            self.arrays = tuple(t.detach().clone() for t in tensors)
            self.event = None
            return
        self.arrays = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True) for t in tensors)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(tensors[0].device))

    def wait(self) -> tuple:
        """The numpy arrays, once the copy has landed (under TRANSFER_LOCK
        when called outside DEVICE_LOCK)."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(a.numpy() for a in self.arrays)


class Exchange:
    """Sim <-> UI bridge: should_store (compare and set), store/sample
    (snapshot), current_ticks, delta/set_delta (live dt)."""

    def __init__(self, n_objects: int, delta: float = constants.DELTA,
                 initial=None):
        # seed the snapshot with the initial positions when given: the
        # frontend's first frame renders before the sim thread's first
        # store, and a zeroed buffer would draw the scene as one dot
        self._sample = (np.array(initial, np.float32, copy=True)
                        if initial is not None
                        else np.zeros((n_objects, 3), np.float32))
        self._lock = threading.Lock()
        self._should_sample = True
        self._tick = 0
        self._sample_tick = 0  # the tick of the positions in _sample
        self._delta = delta
        self._pending = None  # (Readback, tick, wire) from store_pending
        #: highest tick through which a host readback is known to have
        #: drained the stream (consumer snapshots and the sim loop's queue
        #: bound both count)
        self._synced_tick = 0

    # --- dt ---
    def delta(self) -> float:
        with self._lock:
            return self._delta

    def set_delta(self, value: float):
        with self._lock:
            self._delta = value

    # --- handshake ---
    def should_store(self) -> bool:
        """Compare and set the should-sample flag: true at most once per UI
        request."""
        with self._lock:
            if self._should_sample:
                self._should_sample = False
                return True
            return False

    def store(self, positions, tick: int):
        """Publish a float32 position snapshot and the tick count. Neither
        moves back: a snapshot older than the one held is dropped, and the
        tick count stays where `note_ticks` or a newer snapshot put it."""
        snap = np.asarray(positions, np.float32)
        if snap.shape != self._sample.shape:
            raise ValueError(
                f"snapshot shape {snap.shape} != exchange buffer "
                f"{self._sample.shape}; Exchange was sized for a different "
                f"body count")
        with self._lock:
            # two consumers may finish their snapshots out of order: the
            # older one must not replace the newer positions either
            if tick >= self._sample_tick:
                self._sample[:] = snap
                self._sample_tick = tick
            self._tick = max(self._tick, tick)

    def store_pending(self, handle, tick: int, wire: str):
        """Publish a snapshot still in flight (`_snapshot_begin`'s handle);
        the consumer's next sample() waits for it. Latest wins: an
        unconsumed handle is replaced."""
        with self._lock:
            self._pending = (handle, tick, wire)

    def sample(self) -> np.ndarray:
        """The latest snapshot, and a request for a new one. A pending
        handle is finished here, on the consumer's thread, under
        TRANSFER_LOCK and without the exchange lock (the sim thread takes
        DEVICE_LOCK then this lock)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            handle, tick, wire = pending
            with TRANSFER_LOCK:
                snap = _snapshot_finish(handle, wire)
            self.store(snap, tick)
        with self._lock:
            if pending is not None:
                # the snapshot's event drained the stream to its tick
                self._synced_tick = max(self._synced_tick, pending[1])
            out = self._sample.copy()
            self._should_sample = True
        return out

    def synced_tick(self) -> int:
        with self._lock:
            return self._synced_tick

    def note_synced(self, tick: int):
        """Record a wait that drained the stream through ``tick``."""
        with self._lock:
            self._synced_tick = max(self._synced_tick, tick)

    def note_ticks(self, tick: int):
        """Publish the loop's tick count without a snapshot, so that a
        frontend that polls without sampling sees the loop advance."""
        with self._lock:
            self._tick = max(self._tick, tick)

    def current_ticks(self) -> int:
        """Tick counter for progress displays, including a pending
        snapshot's tick. It never decreases."""
        with self._lock:
            if self._pending is not None:
                return max(self._tick, self._pending[1])
            return self._tick


#: snapshot formats of the device-to-host position copy: "f32" the
#: full-precision positions, "u16" each axis quantized to 16 bits across the
#: scene's bounding box on the device (half the bytes; error <= box/65535)
SNAPSHOT_WIRES = ("f32", "u16")


def _snap_f32(pos):
    # a new buffer, independent of the state that later steps replace
    return pos.to(torch.float32, copy=True)


def _snap_u16(pos):
    """(q, params): q the positions quantized to uint16, params row 0 the
    box minimum and row 1 the quantization step."""
    p = pos.to(torch.float32)
    lo = torch.amin(p, dim=0)
    ext = torch.clamp_min(torch.amax(p, dim=0) - lo,
                          torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round((p - lo) * (65535.0 / ext)), 0.0, 65535.0)
    return q.to(torch.uint16), torch.stack([lo, ext / 65535.0])


def _snapshot_begin(state: State, wire: str) -> Readback:
    """Start a snapshot of the current positions: an on-device copy (or
    quantization) and its non-blocking copy to the host, issued now."""
    if wire == "u16":
        return Readback(*_snap_u16(state.pos))
    return Readback(_snap_f32(state.pos))


def _snapshot_finish(handle: Readback, wire: str) -> np.ndarray:
    """Wait for the snapshot and return it on the host as (N, 3) float32."""
    arrays = handle.wait()
    if wire == "u16":
        q, params = arrays
        return q.astype(np.float32) * params[1] + params[0]
    return np.asarray(arrays[0], np.float32)


def _drain(state: State):
    """Wait until the card has run the work queued so far (a no-op off the
    card): the sim loop's queue bound."""
    if state.pos.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(state.pos.device))
        ev.synchronize()


def _recheck_solver(sim, state, fallback_factory):
    """One mid-run solver re-check (sim loop, under DEVICE_LOCK).

    Returns ``(replacement_sim_or_None, caches_stale)``. Order of checks:
    (1) a calibration already flagged degenerate; (2) the PM tier's
    `mesh_resolves` gate on the evolved scene; (3) `maybe_recalibrate` for
    cap drift, falling back iff the REBUILT calibration is degenerate."""
    algo = sim.config.resolved_algorithm()
    reason = None
    if fallback_factory is not None:
        if getattr(sim, "degenerate", None):
            reason = sim.degenerate
        elif algo == "pm":
            grid = (sim.mesh_params or {}).get("grid")
            if grid is not None and not mesh_resolves(state, grid=grid):
                reason = "pm-unresolved"
    recal = False
    if reason is None:
        recal = sim.maybe_recalibrate(state)
        if (recal and fallback_factory is not None
                and getattr(sim, "degenerate", None)):
            reason = sim.degenerate
    if reason is not None:
        new = fallback_factory(reason)
        if new is not None:
            print(f"spacetpu_torch.engine: mid-run solver fallback {algo} -> "
                  f"{new.config.resolved_algorithm()} (reason: {reason})",
                  flush=True)
            return new, True
    return None, recal


def run_sim_loop(
    sim: Simulation,
    state: State,
    exchange: Exchange,
    stop: threading.Event,
    *,
    check_interval: int = constants.CHECK_INTERVAL,
    merge_every: int = 0,
    radii=None,
    on_merge=None,
    snapshot_wire: str = "f32",
    recal_every: int = 0,
    fallback_factory=None,
    on_swap=None,
) -> State:
    """The tick loop: step check_interval ticks, publish a snapshot iff the
    UI asked, re-read dt, exit on the token.

    On a UI request the positions are captured at the END of the batch and
    handed to the exchange as a handle still in flight; the consumer's
    sample() waits for it. The loop's only wait is the queue bound: when no
    readback has drained the stream for SYNC_EVERY ticks, it waits for the
    card, so that a snapshot never queues behind an unbounded backlog of
    steps.

    Every ``recal_every`` ticks (0 = off) the loop re-checks the scene
    (`_recheck_solver`) and, when the solver has left its regime, swaps in
    ``fallback_factory(reason)``, primed on the current state, and reports
    it through ``on_swap(sim)``.

    With ``merge_every`` > 0 and ``radii`` given, every ``merge_every``
    ticks the loop merges the overlapping bodies at the batch's end
    (`collisions.merge_all_overlapping`, one readback a merge), primes the
    state again (the merged rows' cache was zeroed), drops the cached tree
    structure and hands the new radii to ``on_merge`` as float32 numpy."""
    if snapshot_wire not in SNAPSHOT_WIRES:
        raise ValueError(f"unknown snapshot wire {snapshot_wire!r}")

    tick = 0
    last_recal_check = 0
    delta = exchange.delta()

    def cached(s):
        # the tree families rebuild their structure every r ticks and step
        # against it in between
        r = s.config.tree_refresh_every
        return r if r > 1 and s.config.resolved_algorithm() in (
            "tree", "treepm") else 0

    refresh = cached(sim)
    structure = None
    radii_dev = None
    last_merge_tick = 0
    if merge_every and radii is not None:
        radii_dev = torch.as_tensor(_host(radii), dtype=state.pos.dtype,
                                    device=state.pos.device)
    with DEVICE_LOCK:
        state = sim.prime(state)
    while True:
        with DEVICE_LOCK:
            for _ in range(check_interval):
                if refresh:
                    if structure is None or tick % refresh == 0:
                        structure = sim.build_structure(state)
                    state = sim.step_cached(state, structure, delta)
                else:
                    state = sim.step(state, delta)
                tick += 1
            if radii_dev is not None and tick - last_merge_tick >= merge_every:
                from spacetpu_torch.ops import collisions

                last_merge_tick = tick
                with TRANSFER_LOCK:  # each merge reads `merged` back
                    state, radii_dev, k, _ = collisions.merge_all_overlapping(
                        state, radii_dev)
                if k:
                    state = sim.prime(state)  # the merged rows' acc is zero
                    structure = None  # and the cached structure stale
                    if on_merge is not None:
                        on_merge(_host(radii_dev).astype(np.float32))
            if recal_every and tick - last_recal_check >= recal_every:
                last_recal_check = tick
                new_sim, stale = _recheck_solver(sim, state,
                                                 fallback_factory)
                if new_sim is not None:
                    sim = new_sim
                    state = sim.prime(state)
                    refresh = cached(sim)
                    if on_swap is not None:
                        on_swap(sim)
                if stale:
                    structure = None  # recal/swap staled the cached tree
            if tick - exchange.synced_tick() >= constants.SYNC_EVERY:
                with TRANSFER_LOCK:
                    _drain(state)
                exchange.note_synced(tick)
            if exchange.should_store():
                exchange.store_pending(_snapshot_begin(state, snapshot_wire),
                                       tick, snapshot_wire)
            exchange.note_ticks(tick)
        # dt is re-read every batch, sampled or not
        delta = exchange.delta()
        # the stop token is honoured whether or not a sample is pending
        if stop.is_set():
            break
        # give the UI thread a fair shot at DEVICE_LOCK between batches
        time.sleep(0)
    return state


class SimEngine:
    """Owns the sim thread and the exchange: spawn, stop token, join."""

    def __init__(self, sim: Simulation, state: State, *,
                 delta: float = constants.DELTA,
                 check_interval: int = constants.CHECK_INTERVAL,
                 merge_every: int = 0, radii=None,
                 snapshot_wire: str = "f32",
                 recal_every: int = 0,
                 fallback_factory=None):
        self.sim = sim
        self._snapshot_wire = snapshot_wire
        self._recal_every = recal_every
        self._fallback_factory = fallback_factory
        self.exchange = Exchange(state.n, delta,
                                 initial=_host(state.pos).astype(np.float32))
        self._merge_every = merge_every
        self._radii0 = radii
        #: the latest radii after a merge (float32 numpy), swapped whole by
        #: the sim thread; a frontend re-reads it each frame when merging
        self.radii_snapshot = (None if radii is None
                               else _host(radii).astype(np.float32))
        self._stop = threading.Event()
        self._state0 = state
        self.final_state: Optional[State] = None
        #: the exception that killed the sim thread, if any; frontends
        #: re-raise it through check_health
        self.error: Optional[BaseException] = None
        self._check_interval = check_interval
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def run():
            try:
                def on_merge(radii_np):
                    self.radii_snapshot = radii_np  # atomic reference swap

                def on_swap(new_sim):
                    self.sim = new_sim  # atomic reference swap

                self.final_state = run_sim_loop(
                    self.sim, self._state0, self.exchange, self._stop,
                    check_interval=self._check_interval,
                    merge_every=self._merge_every, radii=self._radii0,
                    on_merge=on_merge,
                    snapshot_wire=self._snapshot_wire,
                    recal_every=self._recal_every,
                    fallback_factory=self._fallback_factory,
                    on_swap=on_swap)
            except BaseException as e:  # noqa: BLE001 - surfaced to the UI
                self.error = e

        self._thread = threading.Thread(target=run, name="sim", daemon=True)
        self._thread.start()

    @property
    def algorithm(self) -> str:
        """The solver actually ticking (the mid-run fallback may have
        swapped families since the start)."""
        return self.sim.config.resolved_algorithm()

    def check_health(self):
        """Raise the sim thread's exception in the caller, if it died."""
        if self.error is not None:
            raise RuntimeError("simulation thread failed") from self.error

    def stop(self, timeout: float = 30.0):
        """Set the stop token and join."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def _scene_geometry(scene_state: State, grid: int, margin: float,
                    frac: float, weight: str = "mass"):
    """Host-side (numpy) scene shape summary shared by the solver gates:
    (the cell size h the mesh would pick, the radius around the centre of
    mass holding `frac` of the mass, weight="mass", or of the bodies,
    weight="count"). None for massless scenes. Reads the state back."""
    pos = _host(scene_state.pos).astype(np.float64)
    mass = _host(scene_state.mass).astype(np.float64)
    if scene_state.n_active is not None:
        k = int(scene_state.n_active)
        pos, mass = pos[:k], mass[:k]
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    half = max(0.5 * float((hi - lo).max()) * margin, 1e-30)
    h = 2.0 * half / (grid - 1)  # matches pm.measure_box
    m_tot = float(mass.sum())
    if m_tot <= 0.0:
        return None
    com = (mass[:, None] * pos).sum(axis=0) / m_tot
    r = np.linalg.norm(pos - com, axis=1)
    w = mass if weight == "mass" else np.ones_like(mass)
    order = np.argsort(r)
    csum = np.cumsum(w[order])
    i = int(np.searchsorted(csum, frac * float(w.sum())))
    r_frac = float(r[order[min(i, len(r) - 1)]])
    return h, r_frac


def mesh_resolves(scene_state: State, *, grid: Optional[int] = None,
                  mass_frac: Optional[float] = None,
                  margin: float = 2.0) -> bool:
    """Does a PM mesh at `grid` resolve this scene's mass concentration?
    The cell size h that pm.measure_box would pick must not exceed the
    radius around the centre of mass holding `mass_frac` of the mass
    (default constants.MESH_RESOLVE_MASS_FRAC)."""
    from spacetpu_torch.ops import pm as pm_ops

    if grid is None:
        grid = pm_ops.default_grid(scene_state.n)
    if mass_frac is None:
        mass_frac = constants.MESH_RESOLVE_MASS_FRAC
    geom = _scene_geometry(scene_state, grid, margin, mass_frac)
    if geom is None:
        return False
    h, r_frac = geom
    return h <= r_frac


def treepm_saturates(scene_state: State, *, grid: Optional[int] = None,
                     margin: float = 2.0) -> bool:
    """Would TreePM's short-range cutoff cover about the whole scene? True
    when the radius holding half the bodies sits inside r_cut: the cutoff
    near pass then costs as much as all pairs."""
    from spacetpu_torch.ops import treepm as treepm_ops

    if grid is None:
        grid = treepm_ops.default_grid(scene_state.n)
    geom = _scene_geometry(scene_state, grid, margin, frac=0.5,
                           weight="count")
    if geom is None:
        return True  # massless: no mesh source at all
    h, r_half = geom
    rs, rcut = treepm_ops.split_params(h, rs_cells=treepm_ops.RS_CELLS,
                                       rcut_rs=treepm_ops.RCUT_RS)
    return rcut >= r_half


def resolve_interactive_theta(theta: Optional[float],
                              softening: str = "plummer",
                              multipole_order="auto") -> float:
    """The theta the auto tree tier runs: theta=None maps to
    INTERACTIVE_TREE_THETA where the tree runs quadrupoles and to
    BARNES_HUT_THETA where it runs monopoles."""
    if theta is not None:
        return theta
    order = (2 if softening == "plummer" else 1) \
        if multipole_order == "auto" else int(multipole_order)
    return (constants.INTERACTIVE_TREE_THETA if order >= 2
            else constants.BARNES_HUT_THETA)


def select_solver(scene_state: State, *, profile: str = "interactive",
                  cutoff: int = constants.BARNES_HUT_CUTOFF,
                  substeps: int = 1) -> tuple[str, dict]:
    """The auto-select policy as a function of the scene: returns
    ``(algorithm, extra_sim_kwargs)``. Above MESH_SOLVER_CUTOFF (and
    without multirate substeps) the interactive profile takes PM on the
    first grid of the ladder (the default, then MESH_INTERACTIVE_GRID_MAX)
    whose mesh resolves the scene, and the accurate profile keeps the tree.
    Below it: tree iff N > cutoff, else direct."""
    if profile not in ("interactive", "accurate"):
        raise ValueError(f"unknown profile {profile!r}")
    n = scene_state.n
    if (n > constants.MESH_SOLVER_CUTOFF
            and not (isinstance(substeps, int) and substeps > 1)
            and profile == "interactive"):
        from spacetpu_torch.ops import pm as pm_ops

        ladder = sorted({pm_ops.default_grid(n),
                         constants.MESH_INTERACTIVE_GRID_MAX})
        for grid_c in ladder:
            if mesh_resolves(scene_state, grid=grid_c):
                return "pm", {"pm_grid": grid_c}
    return ("tree" if n > cutoff else "direct"), {}


def make_engine_for(
    scene_state: State,
    *,
    delta: float = constants.DELTA,
    cutoff: int = constants.BARNES_HUT_CUTOFF,
    theta: Optional[float] = None,
    profile: str = "interactive",
    engine_kwargs: Optional[dict] = None,
    **sim_kwargs,
) -> SimEngine:
    """A SimEngine with the solver picked by `select_solver`, on the
    state's device unless `device` is given. Auto tiers run the tree at
    INTERACTIVE_TREE_REFRESH unless tree_refresh_every is given; the mesh
    tiers get the mid-run fallback to the tree (theta >= 0.5), re-checked
    every ENGINE_RECAL_EVERY ticks. engine_kwargs go to SimEngine."""
    n = scene_state.n
    sim_kwargs.setdefault("device", scene_state.pos.device)
    theta = resolve_interactive_theta(
        theta, softening=sim_kwargs.get("softening", "plummer"),
        multipole_order=sim_kwargs.get("multipole_order", "auto"))
    algorithm, extra = select_solver(
        scene_state, profile=profile, cutoff=cutoff,
        substeps=sim_kwargs.get("substeps", 1))
    sim_kwargs = dict(sim_kwargs, **extra)
    if not sim_kwargs.get("tree_refresh_every"):
        sim_kwargs["tree_refresh_every"] = constants.INTERACTIVE_TREE_REFRESH
    if algorithm != "tree":
        sim = make_simulation(n, algorithm=algorithm, **sim_kwargs)
    else:
        sim = make_simulation(n, algorithm=algorithm, theta=theta,
                              **sim_kwargs)
    engine_kwargs = dict(engine_kwargs or {})
    if algorithm in ("pm", "treepm"):
        # the mesh tiers fall back to the tree; the tree is the target and
        # the direct solver has no failure mode
        tree_kwargs = {k: v for k, v in sim_kwargs.items()
                       if k not in ("pm_grid",)}
        fb_theta = max(theta, 0.5)

        def fallback_factory(reason, _n=n, _kw=tree_kwargs, _th=fb_theta):
            return make_simulation(_n, algorithm="tree", theta=_th, **_kw)

        engine_kwargs.setdefault("recal_every", constants.ENGINE_RECAL_EVERY)
        engine_kwargs.setdefault("fallback_factory", fallback_factory)
    return SimEngine(sim, scene_state, delta=delta, **engine_kwargs)
