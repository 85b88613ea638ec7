"""Application entry point: scene -> engine -> frontend (PyTorch).

The counterpart of `spacetpu/main.py`: build the scene (default
fixed_cloud(10000)), start the sim thread, run the chosen frontend, then
stop and join; or, with ``--frontend none``, a headless batch run that
prints its rate, the solver's health and the energy drift. The flags are
the JAX package's (`utils/config.py`), and everything runs on the CUDA card
unless ``--platform cpu`` is given.

Run:  python -m spacetpu_torch --n 2000 --frontend offline
      python -m spacetpu_torch --platform cpu --n 200 --frontend offline \
          --frames 3

The headless run also takes ``--report-encounters`` (the least separation
before and after), ``--merge-collisions EVERY`` (inelastic merges of
overlapping bodies every EVERY steps) and ``--substeps N|auto`` (multirate
stepping; "auto" measures the scene at --dt). ``--shard D`` runs the
headless batch body-sharded over a group of D ranks, one a device (direct
over the ring, PM with one all_reduce of its mesh, the tree and TreePM
with their halo exchange; ``--shard 1`` forms a group of this process
alone), and ``--coordinator``, ``--num-processes`` and ``--process-id``
join the group before anything touches a device (`parallel/multihost.py`).
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from spacetpu_torch import constants
from spacetpu_torch.engine import SimEngine, make_engine_for
from spacetpu_torch.io import checkpoint
from spacetpu_torch.models import presets
from spacetpu_torch.sim import make_simulation
from spacetpu_torch.state import Scene, State, resolve_device
from spacetpu_torch.utils.config import RunConfig, parse_args, resolved_theta


def sharded_algorithm(cfg: RunConfig, n: int) -> str:
    """The algorithm of a --shard run of n bodies ("auto" takes the tree
    above BARNES_HUT_CUTOFF, as the single-device run does)."""
    algo = cfg.algorithm
    if algo == "auto":
        algo = "tree" if n > constants.BARNES_HUT_CUTOFF else "direct"
    return algo


def resolve_platform(cfg: RunConfig) -> torch.device:
    """--platform: 'cpu' is the host; 'auto' and 'gpu' the card (an error
    where there is none)."""
    if cfg.platform == "cpu":
        return torch.device("cpu")
    if cfg.platform not in ("auto", "gpu"):
        raise ValueError(f"unknown platform {cfg.platform!r}")
    return resolve_device("cuda")


def build_scene(cfg: RunConfig) -> Scene:
    fn = presets.PRESETS.get(cfg.preset)
    if fn is None:
        raise SystemExit(
            f"unknown preset {cfg.preset!r}; available: "
            f"{', '.join(sorted(presets.PRESETS))}")
    if cfg.preset in ("fixed_cloud", "fixed_shell"):
        return fn(cfg.n)
    if cfg.preset in ("random_cluster", "plummer_sphere",
                      "colliding_plummers", "earth_sun_mars_ast"):
        return fn(cfg.n, seed=cfg.seed)
    return fn()


def resolve_state(cfg: RunConfig, scene: Scene, device=None
                  ) -> "tuple[State, Scene]":
    """Build the initial State on `device`; with --restore, load the
    checkpoint and prefer its own Scene metadata over the CLI preset, so
    that the renderer and the exchange match the restored body count."""
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    if not cfg.restore:
        return scene.state(dtype=dtype, compensated=cfg.compensated,
                           device=device), scene
    state, ck_scene, _ = checkpoint.load(cfg.restore, dtype=dtype,
                                         device=device)
    if ck_scene is not None:
        scene = ck_scene
        if state.n > scene.n:
            # a padded checkpoint's zero-mass pad rows are inert: trim them
            # so that the engine, exchange and viewer match the scene
            n_old, n_new = state.n, scene.n

            def _trim(v):
                if (isinstance(v, torch.Tensor) and v.dim() >= 1
                        and v.shape[0] == n_old):
                    return v[:n_new]
                return v

            state = State(**{f: _trim(getattr(state, f))
                             for f in State._fields if f != "n_active"},
                          n_active=torch.tensor(n_new, dtype=torch.int32,
                                                device=state.pos.device))
    if state.n != scene.n:
        raise SystemExit(
            f"--restore state has {state.n} bodies but the scene "
            f"({cfg.preset}) has {scene.n}; the checkpoint carries no scene "
            f"metadata, so pass a matching --preset/--n")
    return state, scene


def _cfg_k_near(cfg: RunConfig):
    if cfg.k_near == "default":
        return None
    if cfg.k_near == "auto":
        return "auto"
    return int(cfg.k_near)


def _cfg_tree_kwargs(cfg: RunConfig) -> dict:
    """Tree-tuning flags shared by every Simulation construction site."""
    leaf = cfg.leaf if cfg.leaf == "auto" else int(cfg.leaf)
    far = cfg.far_levels if cfg.far_levels == "auto" else int(cfg.far_levels)
    fast_cap = cfg.fast_cap if cfg.fast_cap == "auto" else int(cfg.fast_cap)
    return dict(
        k_near=_cfg_k_near(cfg), near_mode=cfg.near_mode,
        cluster_mode=cfg.cluster_mode, leaf=leaf, far_levels=far,
        tree_refresh_every=cfg.tree_refresh_every,
        run_chunk=cfg.run_chunk or None,
        substeps=int(cfg.substeps), fast_cap=fast_cap,
        pallas_method=cfg.pallas_method,
        pm_grid=(cfg.pm_grid if cfg.pm_grid == "auto" else int(cfg.pm_grid)),
        pm_margin=cfg.pm_margin,
        pm_rs_cells=cfg.pm_rs_cells, pm_rcut_rs=cfg.pm_rcut_rs,
        pm_split=cfg.pm_split,
    )


def _resolve_auto_substeps(cfg: RunConfig, scene: Scene,
                           state: State) -> State:
    """--substeps auto: prime a probe simulation (plain stepping, the same
    force configuration as the run's) and let `suggest_substeps` pick
    (m, fast_cap) from the measured timescale spread at --dt. Sets
    cfg.substeps (and cfg.fast_cap) in place; returns the primed state."""
    if cfg.integrator != "leapfrog":
        print("note: --substeps auto requires the leapfrog integrator; "
              "plain stepping", flush=True)
        cfg.substeps = "1"
        return state
    cfg.substeps = "1"  # so that _cfg_tree_kwargs parses while probing
    kw = dict(_cfg_tree_kwargs(cfg), substeps=1, fast_cap="auto")
    # probe the configuration that will tick: under --algorithm auto the
    # engine resolves theta=None to the interactive tier's value
    if cfg.algorithm == "auto":
        from spacetpu_torch.engine import resolve_interactive_theta

        probe_theta = resolve_interactive_theta(
            cfg.theta, softening=cfg.softening,
            multipole_order=cfg.multipole_order)
    else:
        probe_theta = resolved_theta(cfg.theta)
    probe = make_simulation(
        state.n, algorithm=cfg.algorithm, backend=cfg.backend,
        integrator=cfg.integrator, softening=cfg.softening, eps=cfg.eps,
        theta=probe_theta, g=scene.g, multipole_order=cfg.multipole_order,
        device=state.pos.device, **kw)
    state = probe.prime(state)
    m, f, reason = probe.suggest_substeps(state, cfg.dt)
    if m > 1:
        print(f"auto substeps: m={m}, fast_cap={f} (measured timescale "
              f"spread at dt={cfg.dt})", flush=True)
    elif reason == "lower-dt":
        print("auto substeps: MOST bodies are under-resolved at this dt — "
              "multirate cannot pay; lower --dt instead", flush=True)
    else:
        print("auto substeps: scene is uniform at this dt — plain "
              "stepping", flush=True)
    cfg.substeps = str(m)
    if m > 1:
        cfg.fast_cap = str(f)
    return state


def build_engine(cfg: RunConfig, scene: Scene, state: State) -> SimEngine:
    """The engine of a frontend run, on the state's device: the auto-select
    (`make_engine_for`) under --algorithm auto, else the pinned solver; with
    --merge-collisions, merging at that cadence with the scene's radii."""
    engine_kw = dict(merge_every=cfg.merge_collisions,
                     radii=scene.radii if cfg.merge_collisions else None,
                     snapshot_wire=cfg.snapshot_wire)
    if cfg.algorithm == "auto":
        return make_engine_for(
            state, delta=cfg.dt, theta=cfg.theta, profile=cfg.profile,
            backend=cfg.backend, integrator=cfg.integrator,
            softening=cfg.softening, eps=cfg.eps, g=scene.g,
            multipole_order=cfg.multipole_order, engine_kwargs=engine_kw,
            **_cfg_tree_kwargs(cfg))
    sim = make_simulation(
        state.n, algorithm=cfg.algorithm, backend=cfg.backend,
        integrator=cfg.integrator, softening=cfg.softening, eps=cfg.eps,
        theta=resolved_theta(cfg.theta), g=scene.g,
        multipole_order=cfg.multipole_order, device=state.pos.device,
        **_cfg_tree_kwargs(cfg))
    return SimEngine(sim, state, delta=cfg.dt, **engine_kw)


def run_headless(cfg: RunConfig, scene: Scene, state: State) -> State:
    """--frontend none: batch stepping with metrics, checkpoints and an
    optional trace; the encounter report and collision merges where asked.
    Returns the final state."""
    from spacetpu_torch.ops import collisions, encounters, energy
    from spacetpu_torch.utils import profiling
    from spacetpu_torch.utils.metrics import (ThroughputTracker,
                                              compute_elapsed_time)

    if cfg.shard:
        return run_headless_sharded(cfg, scene, state)
    dev = state.pos.device
    algorithm, extra_kwargs = cfg.algorithm, {}
    if cfg.algorithm == "auto" and cfg.profile == "accurate":
        # explicit opt-in (the default headless auto keeps the reference's
        # tree-iff-N>1000 parity): the accurate tier's structure-cached
        # tree, through the engine's select_solver
        from spacetpu_torch.engine import select_solver

        algorithm, extra_kwargs = select_solver(
            state, profile="accurate",
            substeps=int(cfg.substeps) if cfg.substeps.isdigit() else 1)
        if algorithm == "tree" and not cfg.tree_refresh_every:
            extra_kwargs = dict(
                extra_kwargs,
                tree_refresh_every=constants.INTERACTIVE_TREE_REFRESH)

    def simulation(algo, theta, **kw):
        return make_simulation(
            state.n, algorithm=algo, backend=cfg.backend,
            integrator=cfg.integrator, softening=cfg.softening, eps=cfg.eps,
            theta=theta, g=scene.g, multipole_order=cfg.multipole_order,
            device=dev, **dict(_cfg_tree_kwargs(cfg), **kw))

    sim = simulation(algorithm, resolved_theta(cfg.theta), **extra_kwargs)
    state = sim.prime(state)
    eps_diag = cfg.eps if cfg.eps is not None else 0.0

    def report_encounters(tag, radii_now=None):
        if not cfg.report_encounters:
            return
        mask = None if radii_now is None else radii_now > 0
        d, i, j = encounters.min_separation(state.pos, mask=mask)
        print(f"min separation ({tag}): {float(d):.6e} "
              f"(bodies {int(i)} <-> {int(j)})", flush=True)

    report_encounters("start")

    def total_energy(s):
        # for --softening ref the potential is the bare 1/r approximation,
        # so the printed drift is exact only for plummer
        return float(energy.total_energy(s.pos, s.vel, s.mass,
                                         softening=cfg.softening,
                                         eps=eps_diag, g=scene.g))

    e0 = total_energy(state)
    trace = (profiling.trace(cfg.profile_dir) if cfg.profile_dir
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    last_report = [t0]
    base = [0]

    def report(at):
        now = time.perf_counter()
        if now - last_report[0] >= 30.0:
            total = base[0] + at
            print(f"  ... {total}/{cfg.steps} steps "
                  f"({total / max(now - t0, 1e-9):.2f} steps/s)", flush=True)
            last_report[0] = now

    radii_dev = None
    merged_total = 0
    energy_lost = 0.0
    if cfg.merge_collisions:
        # scene.radii owns the radii: a --restore of a merged run's
        # checkpoint carries the post-merge radii (absorbed bodies at 0)
        radii_dev = torch.as_tensor(np.asarray(scene.radii),
                                    dtype=state.pos.dtype, device=dev)
    done = 0
    with trace:
        while done < cfg.steps:
            # the host loop stops only at checkpoint, recalibration and
            # merge boundaries
            todo = cfg.steps - done
            for every in (cfg.checkpoint_every, cfg.recalibrate_every,
                          cfg.merge_collisions):
                if every:
                    todo = min(todo, ((done // every) + 1) * every - done)
            base[0] = done
            state = sim.run(state, cfg.dt, todo, progress=report)
            done += todo
            if cfg.merge_collisions and done % cfg.merge_collisions == 0:
                state, radii_dev, k, de = collisions.merge_all_overlapping(
                    state, radii_dev)
                if k:
                    merged_total += k
                    energy_lost += de
                    # kept in the scene's metadata (checkpoints save it)
                    scene.radii = radii_dev.cpu().numpy().astype(np.float32)
                    # the merged rows' acc cache was zeroed: refill it
                    state = sim.prime(state)
                    print(f"  ... step {done}: merged {k} overlapping "
                          f"pair(s) ({merged_total} total; inelastic KE "
                          f"loss {energy_lost:.3e})", flush=True)
            if (cfg.recalibrate_every and done % cfg.recalibrate_every == 0
                    and done < cfg.steps):
                if sim.maybe_recalibrate(state):
                    mp = sim.mesh_params
                    what = (f"box h={mp['h']:.3g}" if mp is not None
                            else f"k_near={sim.caps['k_near']}")
                    print(f"  ... step {done}: scene outgrew the calibrated "
                          f"caps — re-measured ({what})", flush=True)
                if sim.degenerate and cfg.algorithm == "auto":
                    # an auto-selected solver left its regime mid-rollout:
                    # swap families as the engine does (a pinned one only
                    # warns)
                    reason = sim.degenerate
                    sim = simulation("tree",
                                     max(resolved_theta(cfg.theta), 0.5))
                    state = sim.prime(state)
                    print(f"  ... step {done}: FAMILY FALLBACK -> tree "
                          f"(reason: {reason}; caps k_near="
                          f"{sim.caps['k_near']})", flush=True)
            if cfg.checkpoint_every and done % cfg.checkpoint_every == 0:
                checkpoint.save(f"{cfg.checkpoint or 'state'}_{done}.npz",
                                state, scene=scene)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    e1 = total_energy(state)
    rate = ThroughputTracker(state.n).rate(cfg.steps, wall)
    print(f"{cfg.steps} steps of N={state.n} in {wall:.2f}s "
          f"({rate['steps_per_sec']:.2f} steps/s, "
          f"{rate['pairs_per_sec']:.3e} pairs/s)")
    algo = sim.config.resolved_algorithm()
    if algo == "tree":
        health = sim.health(state)
        if health["near_overflow"]:
            print(f"WARNING: {health['near_overflow']} of "
                  f"{health['clusters']} clusters overflowed the near-list "
                  f"cap (k_near={health['k_near']}) — their dropped "
                  f"neighbors fall back to far-field accuracy")
        else:
            print(f"tree health: 0/{health['clusters']} near-list "
                  f"overflows (k_near={health['k_near']})")
    elif algo == "pm":
        health = sim.health(state)
        if health.get("out_of_box"):
            print(f"WARNING: {health['out_of_box']} of {state.n} bodies "
                  f"left the calibrated mesh box (deposit face-clamped — "
                  f"re-run with --recalibrate-every or a larger "
                  f"--pm-margin)")
        else:
            print(f"pm health: 0/{state.n} bodies out of the "
                  f"{health['grid']}^3 mesh box")
    print(f"simulated: {compute_elapsed_time(cfg.steps, cfg.dt)}")
    report_encounters("end", radii_dev)
    if merged_total:
        alive = int(torch.sum(radii_dev > 0))
        print(f"collisions: {merged_total} merger(s); {alive} bodies "
              f"remain; inelastic KE loss {energy_lost:.3e} (part of the "
              f"drift figure below)")
    if e0 != 0.0:
        print(f"relative energy drift: {(e1 - e0) / abs(e0):.3e}")
    else:
        # e.g. fixed_shell: massless tracers + stationary center => E = 0
        print(f"absolute energy drift: {e1 - e0:.3e} (E0 = 0)")
    if cfg.checkpoint:
        checkpoint.save(cfg.checkpoint, state, scene=scene,
                        extra={"steps": cfg.steps, "dt": cfg.dt})
        print(f"checkpoint written to {cfg.checkpoint}")
    return state


def run_headless_sharded(cfg: RunConfig, scene: Scene,
                         state: State) -> State:
    """--frontend none --shard D: the batch run body-sharded over a group of
    D ranks, one a device: direct over the ring (`parallel/ring.py`), PM
    with one all_reduce of its mesh (`parallel/pmshard.py`), the tree and
    TreePM with their halo exchange (`parallel/tree2.py`,
    `parallel/treepmshard.py`). Every rank
    runs it with the whole scene; N is zero-mass padded to the shard grain
    (make_state pad_to) and every rank keeps its rows. The energy, the
    checkpoints and the returned state are the gathered state in user
    order, where the pad rows are massless and add nothing; only rank 0
    prints and writes. Without a group, --shard 1 forms one of this process
    alone and ends it at the end."""
    import torch.distributed as dist

    from spacetpu_torch.parallel import multihost

    d = cfg.shard
    algo = sharded_algorithm(cfg, state.n)
    dev = state.pos.device
    world = multihost.process_count()
    if world != d:
        names = ([f"rank {r}" for r in range(world)] if dist.is_initialized()
                 else [torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"])
        raise SystemExit(
            f"--shard {d} but {world} devices are in the group ({names}); "
            f"run as many ranks as --shard, one a device (--coordinator "
            f"or torchrun)")
    formed = multihost.local_group(dev)
    try:
        return _sharded_batch(cfg, scene, state, algo)
    finally:
        if formed:
            multihost.shutdown()


def _sharded_batch(cfg: RunConfig, scene: Scene, state: State,
                   algo: str) -> State:
    """The body of `run_headless_sharded`, in a group of cfg.shard ranks."""
    import os

    from spacetpu_torch.ops import energy
    from spacetpu_torch.parallel import pmshard, ring, tree2, treepmshard
    from spacetpu_torch.state import make_state
    from spacetpu_torch.utils import profiling
    from spacetpu_torch.utils.metrics import (ThroughputTracker,
                                              compute_elapsed_time)

    d = cfg.shard
    mesh = ring.make_mesh(d)
    dev = state.pos.device

    def say(*a, **kw):
        if mesh.rank == 0:
            print(*a, **kw)

    if int(cfg.substeps) > 1:
        say("note: --substeps (multirate) applies to the single-chip "
            "solvers only; ignored under --shard", flush=True)
    if cfg.merge_collisions or cfg.report_encounters:
        say("note: --merge-collisions/--report-encounters are single-"
            "chip features; ignored under --shard", flush=True)
    if cfg.run_chunk:
        say("note: --run-chunk applies to the single-chip solvers only; "
            "ignored under --shard", flush=True)
    eps_diag = cfg.eps if cfg.eps is not None else 0.0
    k_near = _cfg_k_near(cfg)
    k_near = k_near if isinstance(k_near, int) else None
    n_pad = -(-state.n // d) * d
    if algo == "tree":
        order = cfg.multipole_order
        if order == "auto":
            order = 2 if cfg.softening == "plummer" else 1
        # the SUPER grain where the 3-level far field will engage
        n_pad = tree2.required_n(
            state.n, d, multipole_order=int(order),
            far_levels=(cfg.far_levels if cfg.far_levels == "auto"
                        else int(cfg.far_levels)))
        if cfg.leaf != "auto" or cfg.cluster_mode != "auto":
            say("note: --leaf/--cluster-mode apply to the single-chip "
                "tree only; the sharded tree uses LEAF-body equal-count "
                "clusters", flush=True)
        sim = tree2.ShardedTreeSimulation(
            mesh, n_pad, theta=resolved_theta(cfg.theta),
            softening=cfg.softening, eps=cfg.eps, g=scene.g,
            integrator=cfg.integrator, backend=cfg.backend,
            multipole_order=cfg.multipole_order, far_levels=cfg.far_levels,
            near_mode=cfg.near_mode, k_near=k_near)
    elif algo == "treepm":
        n_pad = treepmshard.required_n(state.n, d)
        sim = treepmshard.ShardedTreePMSimulation(
            mesh, n_pad,
            grid=(cfg.pm_grid if cfg.pm_grid == "auto" else int(cfg.pm_grid)),
            margin=cfg.pm_margin, rs_cells=cfg.pm_rs_cells,
            rcut_rs=cfg.pm_rcut_rs, softening=cfg.softening, eps=cfg.eps,
            g=scene.g, integrator=cfg.integrator, backend=cfg.backend,
            k_near=k_near)
    elif algo == "pm":
        sim = pmshard.ShardedPMSimulation(
            mesh, n_pad,
            grid=(cfg.pm_grid if cfg.pm_grid == "auto" else int(cfg.pm_grid)),
            margin=cfg.pm_margin, softening=cfg.softening, eps=cfg.eps,
            g=scene.g, integrator=cfg.integrator)
    else:
        sim = ring.ShardedSimulation(
            mesh, n_pad, softening=cfg.softening, eps=cfg.eps, g=scene.g,
            integrator=cfg.integrator, backend=cfg.backend)
    say(f"sharding N={state.n} (padded to {n_pad}) over {d} devices "
        f"({algo})", flush=True)
    st = make_state(state.pos, state.vel, state.mass, dtype=state.pos.dtype,
                    pad_to=n_pad, compensated=cfg.compensated, device=dev)

    def total_energy(s):
        return float(energy.total_energy(s.pos, s.vel, s.mass,
                                         softening=cfg.softening,
                                         eps=eps_diag, g=scene.g))

    e0 = total_energy(st)

    def next_todo(done):
        todo = cfg.steps - done
        for every in (cfg.recalibrate_every, cfg.checkpoint_every):
            if every:
                todo = min(todo, ((done // every) + 1) * every - done)
        return todo

    trace = contextlib.nullcontext()
    if cfg.profile_dir:
        trace = profiling.trace(cfg.profile_dir if d == 1 else os.path.join(
            cfg.profile_dir, f"rank{mesh.rank}"))
    t0 = time.perf_counter()
    with trace:
        st = sim.prime(sim.shard_state(st))
        done = 0
        while done < cfg.steps:
            todo = next_todo(done)
            st = sim.run(st, cfg.dt, todo)
            done += todo
            if (algo != "direct" and cfg.recalibrate_every
                    and done < cfg.steps
                    and done % cfg.recalibrate_every == 0
                    and sim.maybe_recalibrate(st)):
                if algo == "pm":
                    say(f"  ... step {done}: bodies left the mesh box — "
                        f"re-measured (h={sim.mesh_params['h']:.3g})",
                        flush=True)
                else:
                    say(f"  ... step {done}: scene outgrew the calibrated "
                        f"caps — re-measured (k_near={sim._k_near})",
                        flush=True)
            if (cfg.checkpoint_every and done % cfg.checkpoint_every == 0
                    and done < cfg.steps):
                snap = sim.user_order(st)  # a collective: every rank
                if mesh.rank == 0:
                    checkpoint.save(
                        f"{cfg.checkpoint or 'state'}_{done}.npz", snap,
                        scene=None, extra={"steps": done, "dt": cfg.dt})
        final = sim.user_order(st)
        telemetry = None
        if algo == "pm":
            telemetry = sim.health(st)
        elif algo != "direct":
            telemetry = sim.diagnose(st)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    e1 = total_energy(final)
    # the rate against the real body count: the pad rows are dead weight,
    # and the figure stays comparable to the single-device run's
    rate = ThroughputTracker(state.n).rate(cfg.steps, wall)
    say(f"{cfg.steps} steps of N={state.n} (padded {n_pad}) on {d} "
        f"devices in {wall:.2f}s "
        f"({rate['steps_per_sec']:.2f} steps/s, "
        f"{rate['pairs_per_sec']:.3e} pairs/s)")
    if telemetry is not None:
        say(f"{algo} telemetry: {telemetry}")
        if telemetry.get("halo_overflow"):
            say(f"warning: the halo cap dropped "
                f"{telemetry['halo_overflow']} remote near clusters at the "
                f"end: their near field was "
                + ("not evaluated (no short-range force)"
                   if algo == "treepm" else "left to the far field")
                + "; --recalibrate-every re-measures the cap")
    say(f"simulated: {compute_elapsed_time(cfg.steps, cfg.dt)}")
    if e0 != 0.0:
        say(f"relative energy drift: {(e1 - e0) / abs(e0):.3e}")
    else:
        say(f"absolute energy drift: {e1 - e0:.3e} (E0 = 0)")
    if cfg.checkpoint and mesh.rank == 0:
        # the scene's metadata stays n-sized; checkpoint.load trims the
        # padded rows back to it on restore
        checkpoint.save(cfg.checkpoint, final, scene=scene,
                        extra={"steps": cfg.steps, "dt": cfg.dt})
        print(f"checkpoint written to {cfg.checkpoint}")
    return final


def main(argv=None):
    """Run the app. Returns the final State of a headless run, or the
    FrameSource of a frontend run (its `.engine.final_state` is the final
    state)."""
    cfg = parse_args(argv)
    if cfg.coordinator:
        # joins the group before anything touches a device
        from spacetpu_torch.parallel import multihost

        multihost.initialize(
            coordinator_address=cfg.coordinator,
            num_processes=cfg.num_processes or None,
            process_id=cfg.process_id if cfg.process_id >= 0 else None,
            device="cpu" if cfg.platform == "cpu" else None)
    if cfg.pm_fft != "auto":
        from spacetpu_torch.ops import pm as pm_ops

        pm_ops.fft_method(cfg.pm_fft)  # validates the name
        pm_ops.PM_FFT_METHOD = cfg.pm_fft
    dev = resolve_platform(cfg)
    scene = build_scene(cfg)
    state, scene = resolve_state(cfg, scene, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Compute devices: [{name}] (platform={dev.type})")
    print(f"Running with {scene.n} objects "
          f"({cfg.preset}, dt={cfg.dt}s, {cfg.frontend})")
    if cfg.substeps == "auto":
        if cfg.shard and cfg.frontend == "none":
            cfg.substeps = "1"  # the sharded paths step uniformly
        else:
            state = _resolve_auto_substeps(cfg, scene, state)

    if cfg.frontend == "none":
        return run_headless(cfg, scene, state)

    from spacetpu_torch.render.viewer import (FrameSource, OfflineViewer,
                                              TerminalViewer)

    engine = build_engine(cfg, scene, state)
    if cfg.algorithm == "auto":
        # the auto-select may pick a mesh solver at large N, whose force
        # accuracy is grid-limited
        mode = ("mesh-accuracy (grid-limited forces)"
                if engine.algorithm in ("pm", "treepm")
                else "exact-near forces")
        print(f"auto solver: {engine.algorithm} [{mode}] at N={state.n}",
              flush=True)
    source = FrameSource(engine, scene, width=cfg.width, height=cfg.height,
                         auto_frame=cfg.auto_frame,
                         trail_length=cfg.trail_length, blend=cfg.blend)
    with engine:
        if cfg.frontend == "offline":
            source.viewer = OfflineViewer(source, cfg.out_dir)
            source.viewer.run(cfg.frames, gif=cfg.gif)
        elif cfg.frontend == "window":
            from spacetpu_torch.render.window import WindowViewer

            source.viewer = WindowViewer(source)
            source.viewer.run(max_frames=cfg.frames)
        else:
            source.viewer = TerminalViewer(source,
                                           graphics=cfg.term_graphics)
            source.viewer.run(max_frames=cfg.frames)
    engine.check_health()
    if cfg.checkpoint and engine.final_state is not None:
        if cfg.merge_collisions and engine.radii_snapshot is not None:
            scene.radii = engine.radii_snapshot  # the merged radii
        checkpoint.save(cfg.checkpoint, engine.final_state, scene=scene)
        print(f"checkpoint written to {cfg.checkpoint}")
    print("Task completed")
    return source


if __name__ == "__main__":
    main(sys.argv[1:])
