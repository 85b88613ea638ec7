#!/usr/bin/env python3
"""Run the sharded paths over D cards, one rank a card, against one card.

    python3 tools/sharded_cards.py [--ranks 4] [--n 262144]
        [--pm-n 1000000] [--tree-n 1000000] [--steps 10]
        [--device cuda|cpu]
    python3 tools/sharded_cards.py --pm-turns 3 [--pm-n 1000000]
        [--steps 20]

Launches D ranks (`spacetpu_torch.parallel.multihost.launch`; NCCL on D
cards, or gloo with ``--device cpu``), each of which runs:

- the direct ring (`ring.ShardedSimulation`) on bench.py's configuration
  (random_cluster(N, seed 0), float32, leapfrog, plummer eps 1e-2, g 1):
  a prime, a warm-up step and --steps timed steps (host clock, each rank
  synchronised and the group at a barrier); the ring's hops alone (D - 1
  batch_isend_irecv of N/D rows of (x, y, z, m)) and its tiles alone
  (`cuda_direct.acc_cross_kernel` of N/D targets against N/D sources, D
  calls), by CUDA events;
- the sharded PM (`pmshard.ShardedPMSimulation`) on fixed_cloud(PM_N),
  grid "auto", float32: the same steps, and the all_reduce of the
  (G+1)^3 mesh by CUDA events;
- the sharded tree (`tree2.ShardedTreeSimulation`: theta 0.5, plummer eps
  1e-3, every other default) and TreePM
  (`treepmshard.ShardedTreePMSimulation`, every default) on
  fixed_cloud(TREE_N) zero-mass padded to the shard grain, float32: the
  same steps, the caps and the overflow telemetry, and the pieces of a
  force pass by CUDA events (`chip_smoke.sharded_pieces`: the resort, the
  halo exchange with its bytes, the summaries' all_gather, TreePM's mesh
  all_reduce); --tree-n 0 leaves them out.

Rank 0 runs make_simulation's direct and PM for the same prime and steps
on its card and prints one JSON line: the ms a step of each path over D
ranks and on one card; the ring's prime force against the single card's
(largest difference over the largest |a|) and against float64 sums on
4,096 sampled targets; the final states' largest differences; the PM's
against the single card's and two single-card runs' own difference
(index_add_'s atomics); out_of_box; for the tree and TreePM, the same
solver on one card (make_simulation with the sharded run's k_near, equal
clusters) for the same prime and steps, and on the sharded final state
(user order) the force of both against direct_vpu on 4,096 sampled
targets and their largest difference over the real rows, over the largest
|a| (for the tree, that of a prime of the sharded solver with the run's
caps on the final real bodies padded as one card pads them,
`chip_smoke.padded_as_single`; the rollout's own as
`tree_rollout_vs_one_card_of_max`); the card's name and power limit. A
rank that fails or hangs fails the launch within 20 minutes.

With --pm-turns T no ranks are launched: on one card, T turns of the PM
step on the same scene, with and without a process group. In each turn,
`make_simulation(algorithm="pm")` in no group ("single"); then, in an NCCL
group of this process alone (`multihost.local_group`), the same
("single_in_group"), `ShardedPMSimulation` at D = 1 ("sharded") and the
same with its mesh all_reduce skipped ("sharded_no_reduce"; the MIN and
MAX of its calibration still run), in alternating order from turn to
turn; the group is destroyed at the end of the turn. Each mode: a prime, a
warm-up step, --steps steps on the host clock ending in a synchronise, and
one step traced by `torch.profiler` (`chip_smoke.device_ops`: the card's
kernels and busy ms). One JSON line a turn, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (DT, cuda_ms, device_ops, nvidia_smi,  # noqa: E402
                        sync)

EPS = 1e-2


def _timed(sim, state, steps, dev, *, group=True):
    """(state, ms a step): a warm-up step, then `steps` steps on the host
    clock ending in a synchronise (and with `group`, the group at a
    barrier before and after)."""
    import torch.distributed as dist

    state = sim.step(state, DT)
    sync(dev)
    if group:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = sim.step(state, DT)
    sync(dev)
    if group:
        dist.barrier()
    return state, 1e3 * (time.perf_counter() - t0) / steps


def _diff(a, b, fields=("pos", "vel", "acc")):
    return {f: float((getattr(a, f) - getattr(b, f)).abs().max())
            for f in fields}


def _rank(args):
    import torch.distributed as dist

    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import cuda_direct, direct
    from spacetpu_torch.parallel import multihost, pmshard, ring

    multihost.initialize(device=args.device)
    try:
        mesh = ring.make_mesh()
        dev = mesh.device
        d, out = mesh.size, {"ranks": mesh.size,
                             "backend": dist.get_backend()}

        scene = presets.random_cluster(args.n, seed=0)
        kw = dict(softening="plummer", eps=EPS, g=scene.g)
        sim = ring.ShardedSimulation(mesh, args.n, **kw)
        state = sim.prime(sim.shard_state(scene.state(device=dev)))
        prime_acc = sim.user_order(state).acc
        for key in cuda_direct.LAUNCHES:
            cuda_direct.LAUNCHES[key] = 0
        state, out["ring_ms_per_step"] = _timed(sim, state, args.steps, dev)
        out["ring_launches_per_step"] = {
            k: v / (args.steps + 1) for k, v in cuda_direct.LAUNCHES.items()}
        ring_final = sim.user_order(state)
        if dev.type == "cuda":
            m = args.n // d
            send = torch.cat([state.pos, state.mass[:, None]], 1)
            recv = torch.empty_like(send)

            def hops():
                for _ in range(d - 1):
                    for w in dist.batch_isend_irecv([
                            dist.P2POp(dist.isend, send, mesh.peer(
                                mesh.rank + 1)),
                            dist.P2POp(dist.irecv, recv, mesh.peer(
                                mesh.rank - 1))]):
                        w.wait()

            def tiles():
                for _ in range(d):
                    cuda_direct.acc_cross_kernel(state.pos, state.pos,
                                                 state.mass, **kw)

            out.update(hops_ms=cuda_ms(hops, 5) if d > 1 else 0.0,
                       hop_bytes=m * 4 * send.element_size(),
                       tiles_ms=cuda_ms(tiles, 5),
                       tile_shape=[m, m],
                       tile_slices=cuda_direct.vpu_slices(
                           state.pos, state.pos, "plummer", EPS))

        pm_scene = presets.fixed_cloud(args.pm_n)
        n_pm = -(-pm_scene.n // d) * d
        pm_state = st.make_state(pm_scene.pos, pm_scene.vel, pm_scene.mass,
                                 pad_to=n_pm, device=dev)
        pm = pmshard.ShardedPMSimulation(mesh, n_pm, g=pm_scene.g)
        ps = pm.prime(pm.shard_state(pm_state))
        ps, out["pm_ms_per_step"] = _timed(pm, ps, args.steps, dev)
        pm_final = pm.user_order(ps)
        out.update(pm_n=pm_scene.n, pm_padded=n_pm,
                   pm_grid=pm.mesh_params["grid"],
                   pm_health=pm.health(ps))
        if dev.type == "cuda":
            g = pm.mesh_params["grid"]
            mesh_c = torch.zeros((g + 1) ** 3, device=dev)
            out.update(all_reduce_ms=cuda_ms(
                lambda: dist.all_reduce(mesh_c), 5),
                all_reduce_bytes=mesh_c.numel() * 4)

        trees = {}
        if args.tree_n:
            trees = _tree_runs(args, mesh, out)

        if mesh.rank == 0:
            for kind, (tsim, ts0, final, acc) in trees.items():
                _tree_one_card(args, kind, tsim, ts0, final, acc, out)
            one = st.make_simulation(args.n, algorithm="direct", device=dev,
                                     **kw)
            s1 = one.prime(scene.state(device=dev))
            scale = float(s1.acc.abs().max())
            out["ring_prime_vs_one_card"] = float(
                (prime_acc - s1.acc).abs().max()) / scale
            idx = torch.as_tensor(np.random.default_rng(0).choice(
                args.n, size=min(4096, args.n), replace=False), device=dev)
            p64 = prime_acc.new_tensor(scene.pos, dtype=torch.float64)
            a64 = direct.acc_cross_chunked(
                p64[idx], p64, p64.new_tensor(scene.mass), chunk=8192, **kw)
            out["ring_prime_vs_f64"] = float(
                (prime_acc[idx].double() - a64).abs().max()
                / a64.abs().max())
            s1, out["one_card_ms_per_step"] = _timed(one, s1, args.steps,
                                                     dev, group=False)
            out["ring_final_vs_one_card"] = _diff(ring_final, s1)

            def pm_one():
                sim1 = st.make_simulation(n_pm, algorithm="pm",
                                          g=pm_scene.g, device=dev)
                s = sim1.prime(pm_state)
                return _timed(sim1, s, args.steps, dev, group=False)

            (a, ms), (b, _) = pm_one(), pm_one()
            out.update(pm_one_card_ms_per_step=ms,
                       pm_vs_one_card=_diff(pm_final, a),
                       pm_one_card_vs_itself=_diff(a, b))
            if dev.type == "cuda":
                out["card"] = nvidia_smi()
            print(json.dumps(out), flush=True)
        dist.barrier()
    finally:
        multihost.shutdown()


def _tree_runs(args, mesh, out) -> dict:
    """The sharded tree and TreePM over the group on fixed_cloud(TREE_N):
    {kind: (simulation, the padded whole starting state, the final state in
    user order, the force held against one card's)}, with each one's ms a
    step, caps, telemetry and pieces in `out`."""
    import dataclasses

    import spacetpu_torch as st
    from chip_smoke import TREE, padded_as_single, sharded_pieces
    from spacetpu_torch.models import presets
    from spacetpu_torch.parallel import tree2, treepmshard

    dev, d = mesh.device, mesh.size
    scene = presets.fixed_cloud(args.tree_n)
    runs = {}
    for kind in ("tree", "treepm"):
        if kind == "tree":
            n_pad = tree2.required_n(scene.n, d, far_levels=2)
            sim = tree2.ShardedTreeSimulation(
                mesh, n_pad, g=scene.g, theta=TREE["theta"],
                softening="plummer", eps=TREE["eps"])
        else:
            n_pad = treepmshard.required_n(scene.n, d)
            sim = treepmshard.ShardedTreePMSimulation(mesh, n_pad, g=scene.g)
        state0 = st.make_state(scene.pos, scene.vel, scene.mass,
                               pad_to=n_pad, device=dev)
        ts = sim.prime(sim.shard_state(state0))
        ts, out[f"{kind}_ms_per_step"] = _timed(sim, ts, args.steps, dev)
        out.update({f"{kind}_n": scene.n, f"{kind}_padded": n_pad,
                    f"{kind}_caps": sim.caps,
                    f"{kind}_diagnose": sim.diagnose(ts)})
        if dev.type == "cuda":
            out[f"{kind}_pieces"] = sharded_pieces(sim, ts, mesh, kind)
        final = sim.user_order(ts)
        acc = final.acc
        if kind == "tree":
            again = dataclasses.replace(sim)
            acc = again.user_order(again.prime(again.shard_state(
                padded_as_single(_real_rows(final, scene.n), n_pad)))).acc
        runs[kind] = (sim, state0, final, acc)
    return runs


def _real_rows(state, n: int):
    """The first n rows of a state (its real bodies) as a state of their
    own."""
    import spacetpu_torch as st

    return st.make_state(state.pos[:n], state.vel[:n], state.mass[:n],
                         dtype=state.pos.dtype, device=state.pos.device)


def _tree_one_card(args, kind, sim, state0, final, acc, out) -> None:
    """Rank 0: the same solver on its card alone (make_simulation with the
    sharded run's k_near and far levels, equal clusters) on the real
    bodies, for the same prime and steps; and both solvers' force on the
    real bodies of the sharded final state against direct_vpu on 4,096
    sampled targets; the largest difference of `acc` from its over its
    largest |a|, and the rollout's for the tree. The single-device solver
    has no pad rows: it gets the real bodies alone, and is calibrated on
    the final ones."""
    import spacetpu_torch as st
    from chip_smoke import TREE
    from spacetpu_torch.ops import cuda_direct

    dev = final.pos.device
    n = out[f"{kind}_n"]
    if kind == "tree":
        kw = dict(algorithm="tree", theta=TREE["theta"], eps=TREE["eps"],
                  cluster_mode="equal", far_levels=sim._far_levels,
                  near_mode=sim._near_mode)
        eps = TREE["eps"]
    else:
        kw = dict(algorithm="treepm", pm_grid=sim.mesh_params["grid"])
        eps = 0.0
    one = st.make_simulation(n, g=sim.g, device=dev, k_near=sim._k_near,
                             **kw)
    s1, out[f"{kind}_one_card_ms_per_step"] = _timed(
        one, one.prime(_real_rows(state0, n)), args.steps, dev, group=False)
    real = _real_rows(final, n)
    one.calibrate(real)
    a1 = one.prime(real).acc
    idx = torch.as_tensor(np.random.default_rng(0).choice(
        n, size=min(4096, n), replace=False), device=dev)
    a_ref = cuda_direct.acc_cross_kernel(final.pos[idx], final.pos,
                                         final.mass, softening="plummer",
                                         eps=eps, g=sim.g)

    def err(a):
        r = (torch.linalg.norm(a[idx] - a_ref, dim=1)
             / torch.linalg.norm(a_ref, dim=1)).double()
        return {"median": float(r.median()),
                "p99": float(torch.quantile(r, 0.99))}

    out.update({f"{kind}_err": err(final.acc),
                f"{kind}_one_card_err": err(a1),
                f"{kind}_one_card_near_overflow": one.health(real)[
                    "near_overflow"],
                f"{kind}_vs_one_card_of_max": float(
                    (acc[:n] - a1).abs().max() / a1.abs().max())})
    if kind == "tree":
        out["tree_rollout_vs_one_card_of_max"] = float(
            (final.acc[:n] - a1).abs().max() / a1.abs().max())


def _pm_turns(args) -> None:
    import torch.distributed as dist

    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.parallel import multihost, pmshard, ring

    dev = torch.device("cuda")
    scene = presets.fixed_cloud(args.pm_n)

    def single():
        return st.make_simulation(scene.n, algorithm="pm", g=scene.g,
                                  device=dev)

    def sharded(reduce=True):
        sim = pmshard.ShardedPMSimulation(ring.make_mesh(1), scene.n,
                                          g=scene.g)
        if not reduce:
            def no_sum(t, op):
                if op != dist.ReduceOp.SUM:
                    dist.all_reduce(t, op=op)
                return t

            sim._all_reduce = no_sum
        return sim

    def timed(sim) -> dict:
        state = scene.state(dtype=torch.float32, device=dev)
        if hasattr(sim, "shard_state"):
            state = sim.shard_state(state)
        state, ms = _timed(sim, sim.prime(state), args.steps, dev,
                           group=False)
        return dict(ms_per_step=ms,
                    **device_ops(lambda: sim.step(state, DT)))

    in_group = {"single_in_group": single, "sharded": sharded,
                "sharded_no_reduce": lambda: sharded(reduce=False)}
    for turn in range(args.pm_turns):
        row = {"turn": turn, "single": timed(single())}
        multihost.local_group()
        try:
            names = list(in_group)
            for name in (names if turn % 2 == 0 else names[::-1]):
                row[name] = timed(in_group[name]())
        finally:
            multihost.shutdown()
        print(json.dumps(row), flush=True)
    print(nvidia_smi(), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--pm-n", type=int, default=1_000_000)
    ap.add_argument("--tree-n", type=int, default=1_000_000,
                    help="bodies of the sharded tree and TreePM runs (0: "
                         "leave them out)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pm-turns", type=int, default=0,
                    help="time the PM on one card in turns, in and out of "
                         "a group, instead of launching ranks")
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank of a launched group")
    args = ap.parse_args(argv)
    if args.rank:
        _rank(args)
        return 0
    if args.pm_turns:
        if not torch.cuda.is_available():
            print("sharded_cards: --pm-turns needs a CUDA card",
                  file=sys.stderr)
            return 2
        _pm_turns(args)
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"sharded_cards: {args.ranks} ranks need as many cards "
              f"(have {torch.cuda.device_count()})", file=sys.stderr)
        return 2
    from spacetpu_torch.parallel import multihost

    outs = multihost.launch(
        [sys.executable, os.path.abspath(__file__), "--rank"]
        + [a for a in (argv if argv is not None else sys.argv[1:])],
        args.ranks, timeout=1200)
    print(outs[0].strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
