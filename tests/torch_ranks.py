"""The ranks of the port's multi-process CPU tests, and their inputs.

    python tests/torch_ranks.py OUT_DIR

runs as one rank of a gloo group of 4 processes
(`spacetpu_torch.parallel.multihost.launch` sets torchrun's variables),
one thread each, for the three test files: the group is formed by ``main
--coordinator`` (tests/test_torch_dsort.py); then the direct ring, the
sharded PM and ``main --shard 4`` (tests/test_torch_sharded.py); then the
sharded tree and TreePM (tests/test_torch_tree2.py); then the bitonic sort
at D = 4 and in two groups of 2, a group of 3 refused, the sharded
checkpoints (over the whole group and over two groups of 2) and the dry
run (tests/test_torch_dsort.py). Rank 0 writes OUT_DIR/ranks.npz:
each case's gathered results, and ``lines``, the JSON of what main
printed. `shared` launches the ranks once for a test session.

This file imports torch, numpy and spacetpu_torch only; the tests import
its input functions to give the JAX package the same inputs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import sys
import time

import numpy as np

#: the ring's cases: bodies, plummer eps, integrator, steps after the
#: prime, dtype, compensated, and the pad-to size (zero-mass rows); each
#: gives its primed acc and its final state
RING_CASES = {
    "rollout": dict(n=128, eps=0.05, steps=10),
    "yoshida4": dict(n=128, eps=0.05, integrator="yoshida4", steps=8),
    "compensated": dict(n=64, eps=0.01, steps=1, dtype="float32",
                        compensated=True),
    "pad_eps0": dict(n=250, eps=0.0, steps=3, pad_to=252),
}
DT = 1e-3

#: ``main --shard 4`` (with --checkpoint added), as in
#: tests/test_engine.py::test_cli_sharded_headless, in float64
MAIN_ARGS = {
    "direct": ["--platform", "cpu", "--preset", "plummer_sphere", "--n",
               "250", "--frontend", "none", "--steps", "3", "--algorithm",
               "direct", "--dt", "1e-3", "--eps", "1e-2", "--shard", "4",
               "--dtype", "float64", "--substeps", "2",
               "--report-encounters"],
    "pm": ["--platform", "cpu", "--preset", "fixed_cloud", "--n", "600",
           "--frontend", "none", "--steps", "3", "--algorithm", "pm",
           "--pm-grid", "32", "--dt", "1e-3", "--shard", "4",
           "--recalibrate-every", "2", "--dtype", "float64"],
    "tree": ["--platform", "cpu", "--preset", "plummer_sphere", "--n",
             "1200", "--frontend", "none", "--steps", "2", "--algorithm",
             "tree", "--k-near", "auto", "--dt", "1e-3", "--eps", "1e-2",
             "--shard", "4", "--recalibrate-every", "1", "--dtype",
             "float64"],
    "treepm": ["--platform", "cpu", "--preset", "fixed_cloud", "--n", "600",
               "--frontend", "none", "--steps", "2", "--algorithm",
               "treepm", "--pm-grid", "32", "--dt", "1e-3", "--shard", "4",
               "--recalibrate-every", "1", "--dtype", "float64"],
}

#: the --coordinator run of the dsort suite: 250 bodies padded to 252,
#: checkpointed, as tests/test_engine.py:620-629 (with the ring)
COORD_ARGS = ["--platform", "cpu", "--preset", "plummer_sphere", "--n",
              "250", "--frontend", "none", "--algorithm", "direct", "--dt",
              "1e-3", "--eps", "1e-2", "--steps", "2", "--shard", "4"]

#: what main prints that both packages print alike (not the timings)
SAME_LINES = (r"(?:sharding N=|note: |(?:pm|tree|treepm) telemetry|"
              r"simulated:|relative energy drift|absolute energy drift|"
              r"  \.\.\. step \d+: ).*")

#: the sharded tree's cases at D = 4 (tests/test_tree2.py's scenes: `ball`,
#: float64, theta 0.5, eps 1e-3, g 1, calibrated at prime): the ball's seed
#: and clusters a rank (2 where not given), SUPER and MID where they are
#: shrunk, and ShardedTreeSimulation's arguments; each gives its primed
#: acc, caps and
#: diagnose, and with `steps` a rollout (its user order after CKPT_AT
#: steps through an npz checkpoint and a second simulation too)
TREE2_CASES = {
    "pairs": dict(seed=1, near_mode="pairs"),
    "strip": dict(seed=2, near_mode="strip", resort_every=4, steps=12),
    "ref": dict(seed=3, near_mode="pairs", softening="ref", eps=None,
                multipole_order=1),
    "far3": dict(seed=4, clusters=4, super=4, near_mode="strip",
                 far_levels=3),
    "far3_mid": dict(seed=9, clusters=4, super=4, mid=4, near_mode="pairs",
                     far_levels=3),
    "halo1": dict(seed=5, near_mode="strip", halo_cap=1),
}
CKPT_AT = 3

#: the sharded TreePM's cases at D = 4 (tests/test_treepm.py:271-330):
#: bodies, seed, velocities, halo cap and steps; grid 32, eps 1e-2, g 1,
#: float64, N zero-mass padded to the shard grain
TREEPM_CASES = {
    "rollout": dict(n=2000, seed=7, moving=True, steps=8),
    "halo1": dict(n=2000, seed=8, halo_cap=1),
}
TREEPM_DT = 1e-4


def ball(n: int, seed: int):
    """tests/test_tree2.py's scene: (pos, vel, mass) float64 numpy of a
    uniform ball."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(0, 1, size=(n, 1)) ** (1 / 3)
    pos = (u * r).astype(np.float64)
    vel = rng.normal(size=(n, 3)) * 1e-3
    mass = rng.uniform(0.5, 1.5, size=n) / n
    return pos, vel, mass


def tree2_args(name: str) -> tuple[int, dict, dict]:
    """(N, ShardedTreeSimulation's keyword arguments, {SUPER, MID}) of a
    case."""
    kw = dict(TREE2_CASES[name])
    for k in ("seed", "steps"):
        kw.pop(k, None)
    n = 4 * 255 * kw.pop("clusters", 2)
    sizes = {"SUPER": kw.pop("super", 64), "MID": kw.pop("mid", 8)}
    args = dict(theta=0.5, eps=1e-3, g=1.0, multipole_order=2,
                far_levels=2)
    args.update(kw)
    return n, args, sizes


def treepm_scene(name: str):
    """(pos, vel, mass) float64 numpy of a TreePM case, unpadded."""
    c = TREEPM_CASES[name]
    rng = np.random.default_rng(c["seed"])
    n = c["n"]
    pos = rng.uniform(-1, 1, (n, 3))
    if c.get("moving"):
        vel = rng.normal(0, 0.05, (n, 3))
        mass = rng.uniform(0.5, 1.0, n)
    else:
        mass = rng.uniform(0.5, 1.0, n)
        vel = np.zeros((n, 3))
    return pos, vel, mass


def ring_scene(n: int):
    """(pos, vel, mass) float64 numpy of random_cluster(n, seed=5)."""
    from spacetpu_torch.models import presets

    s = presets.random_cluster(n, seed=5)
    return s.pos, s.vel, s.mass


def plummer_cloud(n, seed=0, scale=1.0, trunc=0.9):
    """tests/test_pm.py's truncated Plummer sphere (pos, mass)."""
    rng = np.random.default_rng(seed)
    m_enc = rng.uniform(0.0, trunc, n)
    r = scale / np.sqrt(m_enc ** (-2.0 / 3.0) - 1.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = r[:, None] * u
    mass = rng.uniform(0.5, 1.5, n)
    return pos, mass


def sort_keys(d: int, seed: int, high: int, m: int):
    """(keys int32, values float32 (n, 3)) of a sort over d ranks of m."""
    rng = np.random.default_rng(seed)
    n = d * m
    return (rng.integers(0, high, n).astype(np.int32),
            rng.normal(size=(n, 3)).astype(np.float32))


#: the sorts: group ranks, key seed, key range, rows a rank
SORTS = {"d4": ((0, 1, 2, 3), 0, 2 ** 31, 1024),
         "d2a": ((0, 1), 2, 2 ** 31, 512),
         "d2b": ((2, 3), 3, 2 ** 31, 512),
         "dup": ((0, 1, 2, 3), 1, 7, 512)}


#: the PM's bodies moved out to trigger its recalibration, and how far
PM_MOVED, PM_OUT = 30, 80.0

#: seconds that the launch of the ranks may take: they share the machine
#: with the suite's other workers
LAUNCH_S = 360.0

_SHARED = None


def shared(tmp_path_factory) -> "Launched":
    """The one launch of the ranks in a test session, whichever test file
    asks first. Under pytest-xdist the workers of a session share it
    through the session's temporary directory: the worker that makes
    OUT_DIR launches, the others wait for its results."""
    global _SHARED
    if _SHARED is None:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent
        _SHARED = Launched(root / "torch_ranks")
    return _SHARED


class Launched:
    """The 4 ranks, launched in a thread of the test process (which
    meanwhile runs the JAX side) where this process made `out_dir`, else by
    another process; `results()` waits for them, at most LAUNCH_S seconds,
    and reads rank 0's file."""

    def __init__(self, out_dir: pathlib.Path):
        self.out_dir, self._res, self._done = out_dir, None, None
        try:
            out_dir.mkdir()
        except FileExistsError:
            return
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(1)
        self._done = self._pool.submit(self._launch)

    def _launch(self) -> None:
        from spacetpu_torch.parallel import multihost

        try:
            multihost.launch([sys.executable, __file__, str(self.out_dir)], 4,
                             timeout=LAUNCH_S)
        except BaseException as e:
            (self.out_dir / "failed.txt").write_text(str(e))
            raise

    def _wait_for_launcher(self) -> None:
        # the launch began before this wait, and ends within its limit
        deadline = time.monotonic() + LAUNCH_S
        while not (self.out_dir / "ranks.npz").exists():
            if (self.out_dir / "failed.txt").exists():
                raise RuntimeError((self.out_dir / "failed.txt").read_text())
            if time.monotonic() > deadline:
                raise TimeoutError(f"no results in {self.out_dir}")
            time.sleep(0.1)

    def results(self) -> dict:
        if self._res is None:
            if self._done is None:
                self._wait_for_launcher()
            else:
                try:
                    self._done.result()
                finally:
                    self._pool.shutdown()
            with np.load(self.out_dir / "ranks.npz") as z:
                self._res = {k: z[k][()] if z[k].ndim == 0 else z[k]
                             for k in z.files}
        return self._res


def _main_lines(argv) -> list[str]:
    """Run main(argv) and return what it printed."""
    from spacetpu_torch.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _ring_case(mesh, n, eps, integrator="leapfrog", steps=0,
               dtype="float64", compensated=False, pad_to=None):
    import torch

    from spacetpu_torch.parallel import ring
    from spacetpu_torch.state import make_state

    pos, vel, mass = ring_scene(n)
    st = make_state(pos, vel, mass, dtype=getattr(torch, dtype),
                    compensated=compensated, pad_to=pad_to, device="cpu")
    sim = ring.ShardedSimulation(mesh, st.n, softening="plummer", eps=eps,
                                 g=1.0, integrator=integrator)
    primed = sim.prime(sim.shard_state(st))
    out = {"prime_acc": sim.user_order(primed).acc.numpy()}
    full = sim.user_order(sim.run(primed, DT, steps))
    out.update({f: getattr(full, f).numpy() for f in
                ("pos", "vel", "acc", "pos_c", "vel_c")
                if getattr(full, f) is not None})
    return out


def _pm_cases(mesh) -> dict:
    """10 steps of the sharded PM; then, after them, the recalibration:
    none for the run's own state, then one for the starting cloud with
    PM_MOVED bodies moved PM_OUT times out, and a prime in the new box."""
    import torch

    from spacetpu_torch.parallel import pmshard, ring
    from spacetpu_torch.state import make_state

    out = {}
    pos, mass = plummer_cloud(512, seed=11)
    sh = pmshard.ShardedPMSimulation(mesh, 512, grid=32, g=1.0)
    ts = sh.prime(sh.shard_state(make_state(
        pos, np.zeros_like(pos), mass, dtype=torch.float64, device="cpu")))
    out["pm_h"] = sh.mesh_params["h"]
    ts = sh.run(ts, DT, 10)
    full = sh.user_order(ts)
    out.update(pm_pos=full.pos.numpy(), pm_vel=full.vel.numpy(),
               pm_out_of_box=sh.health(ts)["out_of_box"])

    out["recal_first"] = sh.maybe_recalibrate(ts)
    moved = pos.copy()
    moved[:PM_MOVED] *= PM_OUT
    whole = make_state(moved, np.zeros_like(moved), mass,
                       dtype=torch.float64, device="cpu")
    out["recal_second"] = sh.maybe_recalibrate(
        ts._replace(pos=ring.shard_state(mesh, whole).pos))
    out["recal_h_new"] = sh.mesh_params["h"]
    out["recal_out_of_box"] = sh.health(
        sh.prime(sh.shard_state(whole)))["out_of_box"]
    return out


def _tree2_cases(mesh, out_dir: pathlib.Path) -> dict:
    """tests/test_torch_tree2.py's results of the sharded tree."""
    import torch
    import torch.distributed as dist

    from spacetpu_torch.io import checkpoint as ck
    from spacetpu_torch.ops import tree as tree_ops
    from spacetpu_torch.parallel import tree2
    from spacetpu_torch.state import make_state

    out = {}
    sizes_were = {"SUPER": tree_ops.SUPER, "MID": tree_ops.MID}
    for name, case in TREE2_CASES.items():
        n, kw, sizes = tree2_args(name)
        for k, v in sizes.items():
            setattr(tree_ops, k, v)
        try:
            pos, vel, mass = ball(n, case["seed"])
            whole = make_state(pos, vel, mass, dtype=torch.float64,
                               device="cpu")
            sim = tree2.ShardedTreeSimulation(mesh, n, **kw)
            ts = sim.prime(sim.shard_state(whole))
            out[f"t2_{name}_acc"] = sim.user_order(ts).acc.numpy()
            out[f"t2_{name}_caps"] = json.dumps(sim.caps)
            out[f"t2_{name}_diag"] = json.dumps(sim.diagnose(ts))
            out[f"t2_{name}_finite"] = bool(torch.isfinite(
                ts.state.acc).all())
            if not case.get("steps"):
                continue
            ts = sim.run(ts, DT, CKPT_AT)
            snap = sim.user_order(ts)
            path = str(out_dir / f"tree2_{name}.npz")
            if mesh.rank == 0:
                ck.save(path, snap)
            dist.barrier()
            loaded, _, _ = ck.load(path, device="cpu")
            sim2 = tree2.ShardedTreeSimulation(
                mesh, n, k_near=sim._k_near, k_super=sim.k_super, **kw)
            ts2 = sim2.prime(sim2.shard_state(loaded))
            out[f"t2_{name}_restored_same"] = all(
                torch.equal(getattr(sim2.user_order(ts2), f),
                            getattr(snap, f)) for f in ("pos", "vel",
                                                        "mass"))
            # the resumed and the continued run, CKPT_AT steps on
            out[f"t2_{name}_resumed"] = sim2.user_order(
                sim2.run(ts2, DT, CKPT_AT)).pos.numpy()
            ts = sim.run(ts, DT, CKPT_AT)
            out[f"t2_{name}_continued"] = sim.user_order(ts).pos.numpy()
            final = sim.user_order(sim.run(ts, DT,
                                           case["steps"] - 2 * CKPT_AT))
            out[f"t2_{name}_pos"] = final.pos.numpy()
            out[f"t2_{name}_vel"] = final.vel.numpy()
        finally:
            for k, v in sizes_were.items():
                setattr(tree_ops, k, v)
    return out


def _treepm_cases(mesh) -> dict:
    """tests/test_torch_tree2.py's results of the sharded TreePM."""
    import torch

    from spacetpu_torch.parallel import treepmshard
    from spacetpu_torch.state import make_state

    out = {}
    for name, case in TREEPM_CASES.items():
        pos, vel, mass = treepm_scene(name)
        n = treepmshard.required_n(case["n"], 4)
        sim = treepmshard.ShardedTreePMSimulation(
            mesh, n, grid=32, eps=1e-2, g=1.0,
            halo_cap=case.get("halo_cap"))
        ts = sim.prime(sim.shard_state(make_state(
            pos, vel, mass, dtype=torch.float64, pad_to=n, device="cpu")))
        out[f"tpm_{name}_diag"] = json.dumps(sim.diagnose(ts))
        out[f"tpm_{name}_caps"] = json.dumps(sim.caps)
        out[f"tpm_{name}_finite"] = bool(torch.isfinite(ts.state.acc).all())
        if case.get("steps"):
            ts = sim.run(ts, TREEPM_DT, case["steps"])
            out[f"tpm_{name}_pos"] = sim.user_order(ts).pos.numpy()
            out[f"tpm_{name}_recal"] = sim.maybe_recalibrate(ts)
    return out


def _halo_fit_cases(mesh) -> dict:
    """The halo cap fitted where the default one is short: with
    tree2.HALO_MIN 0 the default is G_l / 2 = 1 cluster, and prime raises
    it to the measured need (at most G_l = 2). The tree's strip case
    primed so, and at an explicit cap of 1 (its drops); TreePM's rollout
    case so."""
    import torch

    from spacetpu_torch.parallel import tree2, treepmshard
    from spacetpu_torch.state import make_state

    out = {}
    floor = tree2.HALO_MIN
    tree2.HALO_MIN = 0
    try:
        n, kw, _ = tree2_args("strip")
        pos, vel, mass = ball(n, TREE2_CASES["strip"]["seed"])
        whole = make_state(pos, vel, mass, dtype=torch.float64, device="cpu")
        for cap in (1, None):
            sim = tree2.ShardedTreeSimulation(mesh, n, halo_cap=cap, **kw)
            ts = sim.prime(sim.shard_state(whole))
            out[f"fit_tree_{cap}_diag"] = json.dumps(sim.diagnose(ts))
        out["fit_tree_acc"] = sim.user_order(ts).acc.numpy()
        out["fit_tree_caps"] = json.dumps(sim.caps)

        case = TREEPM_CASES["rollout"]
        pos, vel, mass = treepm_scene("rollout")
        n = treepmshard.required_n(case["n"], 4)
        sim = treepmshard.ShardedTreePMSimulation(mesh, n, grid=32, eps=1e-2,
                                                  g=1.0)
        ts = sim.prime(sim.shard_state(make_state(
            pos, vel, mass, dtype=torch.float64, pad_to=n, device="cpu")))
        ts = sim.run(ts, TREEPM_DT, case["steps"])
        out["fit_tpm_pos"] = sim.user_order(ts).pos.numpy()
        out["fit_tpm_diag"] = json.dumps(sim.diagnose(ts))
        out["fit_tpm_caps"] = json.dumps(sim.caps)
    finally:
        tree2.HALO_MIN = floor
    return out


def _sharded_cases(mesh, out_dir: pathlib.Path) -> tuple[dict, dict]:
    """tests/test_torch_sharded.py's results, and what main printed."""
    res = {}
    for name, kw in RING_CASES.items():
        for f, v in _ring_case(mesh, **kw).items():
            res[f"{name}_{f}"] = v
    res.update(_pm_cases(mesh))
    lines = {}
    for name, argv in MAIN_ARGS.items():
        lines[name] = _main_lines(
            argv + ["--checkpoint", str(out_dir / f"main_{name}.npz")])
    return res, lines


def _gather_rows(t, group):
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts).numpy()


def run_all(out_dir: pathlib.Path) -> dict:
    import torch
    import torch.distributed as dist

    from spacetpu_torch.io import checkpoint as ck
    from spacetpu_torch.parallel import dryrun, dsort, multihost, ring
    from spacetpu_torch.state import make_state

    # the group comes from main's flags alone
    env = {k: os.environ.pop(k) for k in
           ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK")}
    lines = {"coordinator": _main_lines(COORD_ARGS + [
        "--coordinator", f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        "--num-processes", env["WORLD_SIZE"], "--process-id", env["RANK"],
        "--checkpoint", str(out_dir / "padded.npz")])}
    res = {"world": multihost.process_count(),
           "index": multihost.process_index()}
    mesh = ring.make_mesh(4)
    rank = mesh.rank
    sharded, main_lines = _sharded_cases(mesh, out_dir)
    res.update(sharded)
    res.update(_tree2_cases(mesh, out_dir))
    res.update(_treepm_cases(mesh))
    res.update(_halo_fit_cases(mesh))
    lines.update(main_lines)
    res["lines"] = json.dumps(lines)
    groups = {name: dist.new_group(list(ranks))
              for name, (ranks, *_rest) in SORTS.items()}
    trio = dist.new_group([0, 1, 2])
    for name, (ranks, seed, high, m) in SORTS.items():
        if rank not in ranks:
            continue
        keys, vals = sort_keys(len(ranks), seed, high, m)
        r = ranks.index(rank)
        tag = torch.arange(r * m, (r + 1) * m, dtype=torch.int32)
        k, v, t = dsort.bitonic_sort_sharded(
            torch.from_numpy(keys[r * m:(r + 1) * m]),
            torch.from_numpy(vals[r * m:(r + 1) * m]), tag,
            group=groups[name])
        got = [_gather_rows(x, groups[name]) for x in (k, v, t)]
        if r == 0:
            # the first rank of each group keeps the group's results
            res.update({f"{name}_keys": got[0], f"{name}_vals": got[1],
                        f"{name}_tag": got[2]})
    if rank in (0, 1, 2):
        try:
            dsort.bitonic_sort_sharded(torch.zeros(8, dtype=torch.int32),
                                       group=trio)
            res["trio"] = "sorted"
        except ValueError as e:
            res["trio"] = str(e)
    # the d2b group's results live on rank 2: bring them to rank 0
    if rank in (0, 2):
        keys, vals = sort_keys(2, SORTS["d2b"][1], 2 ** 31, 512)
        for f, like in (("keys", keys), ("vals", vals),
                        ("tag", np.zeros(1024, np.int32))):
            t = (torch.from_numpy(res[f"d2b_{f}"]) if rank == 2
                 else torch.empty(like.shape, dtype=torch.from_numpy(
                     like).dtype))
            if rank == 2:
                dist.send(t, 0)
            else:
                dist.recv(t, 2)
                res[f"d2b_{f}"] = t.numpy()

    rng = np.random.default_rng(0)
    n = 4 * 32
    whole = make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
                       rng.uniform(0.5, 1.5, n), dtype=torch.float32,
                       compensated=True, device="cpu")
    local = ring.shard_state(mesh, whole)
    path = str(out_dir / "orbax_sharded")
    ck.save_orbax(path, local, extra={"steps": 3}, mesh=mesh)
    back, extra = ck.load_orbax(path, like=local, mesh=mesh)
    same = all(torch.equal(getattr(back, f), getattr(local, f))
               for f in ck._FIELDS if getattr(local, f) is not None)
    res.update(orbax_same=bool(same), orbax_extra=json.dumps(extra),
               orbax_pos=whole.pos.numpy(), orbax_vel_c=whole.vel_c.numpy())
    # a mesh over each group of 2: its ranks alone write and read the
    # whole state, in halves
    pair = "d2a" if rank in SORTS["d2a"][0] else "d2b"
    sub = ring.make_mesh(2, group=groups[pair])
    half = ring.shard_state(sub, whole)
    path = str(out_dir / f"orbax_{pair}")
    ck.save_orbax(path, half, mesh=sub)
    back, _ = ck.load_orbax(path, like=half, mesh=sub)
    ok = torch.tensor([int(all(
        torch.equal(getattr(back, f), getattr(half, f))
        for f in ck._FIELDS if getattr(half, f) is not None))])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    res["orbax_pairs_same"] = bool(ok)
    dryrun.run_rank(mesh)
    res["dryrun"] = True
    return res


def main(argv) -> int:
    import torch

    torch.set_num_threads(1)
    out_dir = pathlib.Path(argv[0])
    from spacetpu_torch.parallel import multihost

    try:
        res = run_all(out_dir)
        if multihost.process_index() == 0:
            # written whole, then named: a waiting process reads it whole
            np.savez(out_dir / "ranks.part.npz", **res)
            os.replace(out_dir / "ranks.part.npz", out_dir / "ranks.npz")
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
