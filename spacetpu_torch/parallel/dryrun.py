"""Dry run of the sharded paths over n ranks (PyTorch).

The counterpart of `__graft_entry__.dryrun_multichip`: n ranks, one a
device, each run a prime and one step of the direct ring
(`ring.ShardedSimulation`) and of the sharded PM
(`pmshard.ShardedPMSimulation`) on a random cluster of 16 bodies a rank,
and of the sharded tree (`tree2.ShardedTreeSimulation`, calibrated at
prime) and TreePM (`treepmshard.ShardedTreePMSimulation`) on LEAF bodies a
rank over the largest power-of-two group of the first ranks (the bitonic
resort's), and check that the results are finite. The ranks use NCCL where
there are n cards, else gloo on the CPU (the JAX package falls back to
virtual CPU devices the same way).

    python -m spacetpu_torch.parallel.dryrun 4    # launches 4 ranks
"""

from __future__ import annotations

import argparse
import sys

import torch

from spacetpu_torch.parallel import multihost


def dryrun_multichip(n_devices: int) -> str:
    """Launch `n_devices` ranks of the dry run and wait for them; returns
    (and prints) the backend they used, "nccl" or "gloo". Raises
    RuntimeError, with every rank's output, where a rank fails or the ranks
    are not done within `multihost.TIMEOUT_S` seconds."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= n_devices else "gloo"
    multihost.launch(
        [sys.executable, "-m", "spacetpu_torch.parallel.dryrun", "--rank",
         "--device", "cuda" if backend == "nccl" else "cpu"],
        n_devices)
    print(f"dryrun_multichip({n_devices}): the direct ring, the sharded "
          f"PM, tree and TreePM ran a prime and a step on {n_devices} "
          f"rank(s) over {backend}", flush=True)
    return backend


def run_rank(mesh) -> None:
    """This rank's part of the dry run in the group of `mesh`: a prime and
    a step of the ring, the sharded tree, the sharded PM and the sharded
    TreePM (seeds 0-3, as the JAX package's), finite positions, a line.
    The tree and TreePM run over the largest power-of-two group of the
    first ranks; every rank of `mesh` calls this."""
    import torch.distributed as dist

    from spacetpu_torch.models import presets
    from spacetpu_torch.parallel import pmshard, ring, tree2, treepmshard

    d2 = 1 << (mesh.size.bit_length() - 1)
    mesh2 = mesh
    if d2 != mesh.size:
        group = dist.new_group([mesh.peer(r) for r in range(d2)])
        mesh2 = (ring.make_mesh(d2, group=group) if mesh.rank < d2
                 else None)
    n, n2 = 16 * mesh.size, d2 * tree2.LEAF
    sims = {
        "direct": lambda: ring.ShardedSimulation(
            mesh, n, softening="plummer", eps=1e-2, g=1.0,
            integrator="leapfrog", algorithm="direct"),
        "tree": lambda: tree2.ShardedTreeSimulation(
            mesh2, n2, theta=0.5, softening="plummer", eps=1e-2, g=1.0,
            multipole_order=2, far_levels=2),
        "pm": lambda: pmshard.ShardedPMSimulation(
            mesh, n, grid=32, softening="plummer", g=1.0,
            integrator="leapfrog"),
        "treepm": lambda: treepmshard.ShardedTreePMSimulation(
            mesh2, n2, grid=32, softening="plummer", eps=1e-2, g=1.0),
    }
    for seed, (name, make) in enumerate(sims.items()):
        if name in ("tree", "treepm") and mesh2 is None:
            continue
        sim = make()
        scene = presets.random_cluster(sim.n, seed=seed, g=1.0)
        st = sim.shard_state(scene.state(dtype=torch.float32,
                                         device=mesh.device))
        st = sim.step(sim.prime(st), 1e-3)
        pos = getattr(st, "state", st).pos
        if not bool(torch.isfinite(pos).all()):
            raise SystemExit(f"dryrun rank {mesh.rank}: non-finite "
                             f"positions ({name})")
    print(f"rank {mesh.rank} of {mesh.size}: ok on {mesh.device}",
          flush=True)


def _rank(device: str) -> None:
    """One launched rank of the dry run (its group from torchrun's
    variables)."""
    from spacetpu_torch.parallel import ring

    if not multihost.initialize(device=device):
        raise SystemExit("dryrun rank: no group settings in the environment")
    try:
        run_rank(ring.make_mesh())
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1,
                    help="ranks to launch (default 1)")
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank of a launched group")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.rank:
        _rank(args.device)
    else:
        dryrun_multichip(args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
