"""Multi-device body sharding: the ring-pass all-pairs force (PyTorch).

The counterpart of `spacetpu/parallel/ring.py` on `torch.distributed`, one
rank a device. Each rank holds N/D rows of the state (its targets) and the
(pos, mass) shards travel once around the ring, one hop a step: D tiles,
D - 1 hops, the tiles summed in hop order, ``acc = acc + tile`` from zeros,
as the JAX package's unrolled loop sums them. A hop is one
`batch_isend_irecv` to rank + 1 and from rank - 1, posted before the tile
of the shard in hand, so that the copy runs under the kernel (on NCCL the
P2P ops run on their own stream); two receive buffers take turns, so a
shard still in flight is never overwritten.

The tile is `cuda_direct.acc_cross_kernel` on the card (``direct_vpu``, the
counterpart of `pallas_direct.acc_cross_pallas`) and its plain version on
the CPU. Self pairs within a shard, and the zero-mass pad rows that
`make_state(pad_to=...)` parks at the origin, add exactly 0: the weight's
r^2 = 0 mask at eps = 0, the mass 0 of a pad row otherwise.

At D = 1 the ring is ``zeros + tile`` of the whole state: the bits of
`make_simulation`'s direct path on the same inputs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.distributed as dist

from spacetpu_torch import constants
from spacetpu_torch.ops import cuda_direct, direct, integrators
from spacetpu_torch.parallel import multihost
from spacetpu_torch.sim import SimConfig
from spacetpu_torch.state import State


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group that the bodies are sharded over, one rank a device:
    its size, this rank, this rank's device and the group (None: the
    default group)."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    def peer(self, r: int) -> int:
        """The global rank of group rank `r` (P2P ops take global ranks)."""
        r %= self.size
        return r if self.group is None else dist.get_global_rank(
            self.group, r)


def make_mesh(n_devices: int | None = None, group=None) -> Mesh:
    """The process group as a 1-D mesh over the bodies. Raises where no
    group exists (`multihost.initialize` or `multihost.local_group` forms
    one) and where `n_devices` is not the group's size: there is one rank a
    device, so the mesh is the group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call multihost.initialize() (or "
            "multihost.local_group() for one rank) first")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a "
                         f"group of {size} ranks (one rank a device)")
    return Mesh(size=size, rank=dist.get_rank(group),
                device=multihost.device(), group=group)


def _ring_acc(pos_i, mass_i, *, mesh: Mesh, tile_acc: Callable):
    """The acceleration of this rank's targets from every shard: the tile
    of the shard in hand, while the next hop's (pos, mass) is in flight."""
    n_dev = mesh.size
    acc = torch.zeros_like(pos_i)
    pos_j, mass_j = pos_i, mass_i
    if n_dev > 1:
        send = torch.cat([pos_i, mass_i[:, None]], dim=1)
        bufs = (torch.empty_like(send), torch.empty_like(send))
        nxt, prv = mesh.peer(mesh.rank + 1), mesh.peer(mesh.rank - 1)
    for d in range(n_dev):
        if d < n_dev - 1:
            recv = bufs[d % 2]
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, nxt, mesh.group),
                dist.P2POp(dist.irecv, recv, prv, mesh.group)])
        acc = acc + tile_acc(pos_i, pos_j, mass_j)
        if d < n_dev - 1:
            for w in works:
                w.wait()
            send = recv
            pos_j, mass_j = recv[:, :3], recv[:, 3]
    return acc


def check_divisible(n: int, mesh: Mesh) -> None:
    if n % mesh.size != 0:
        raise ValueError(
            f"N={n} must be divisible by mesh size {mesh.size}; "
            f"pad with make_state(pad_to=...)")


class ShardedFacade:
    """What the body-sharded simulations share: `step` on this rank's
    shard (a subclass's), `run` as a loop of it, `shard_state` and
    `user_order`. Needs `mesh` and `n`."""

    def _check(self, state: State):
        rows = self.n // self.mesh.size
        if state.pos.shape[0] != rows:
            raise ValueError(
                f"a shard has {rows} rows (N={self.n} over "
                f"{self.mesh.size} ranks); got {state.pos.shape[0]}: pass "
                f"shard_state(state)")

    def run(self, state: State, dt, steps: int) -> State:
        for _ in range(steps):
            state = self.step(state, dt)
        return state

    def shard_state(self, state: State) -> State:
        return shard_state(self.mesh, state)

    def user_order(self, state: State) -> State:
        return gather_state(self.mesh, state)


@dataclasses.dataclass
class ShardedSimulation(ShardedFacade):
    """Body-sharded all-pairs N-body simulation over a group of ranks.

    Integration is elementwise, so it stays on each rank; only the force
    pass talks, over the ring. `prime`, `step` and `run` take and return
    this rank's shard of the state (`shard_state`); `user_order` gathers
    the whole state on every rank. Every integrator of `make_simulation`
    runs here, compensated float32 included."""

    mesh: Mesh
    n: int
    softening: str = "plummer"
    eps: float | None = None
    g: float = constants.G
    integrator: str = "leapfrog"
    backend: str = "auto"  # "cuda" | "torch" | "auto" (JAX names accepted)
    algorithm: str = "direct"  # the sharded tree: tree2.ShardedTreeSimulation

    def __post_init__(self):
        check_divisible(self.n, self.mesh)
        if self.algorithm != "direct":
            raise ValueError(
                f"ShardedSimulation supports algorithm='direct' only (got "
                f"{self.algorithm!r}); for the sharded tree use "
                f"spacetpu_torch.parallel.tree2.ShardedTreeSimulation")
        eps, _ = direct._defaults(self.softening, self.eps, self.g)
        backend = SimConfig(n=self.n, backend=self.backend).resolved_backend(
            self.mesh.device)
        tile = (cuda_direct.acc_cross_kernel if backend == "cuda"
                else cuda_direct.acc_cross_plain)
        self.tile_acc = functools.partial(tile, softening=self.softening,
                                          eps=eps, g=self.g)
        self.acc_fn = functools.partial(_ring_acc, mesh=self.mesh,
                                        tile_acc=self.tile_acc)
        self._stepper = integrators.get_stepper(self.integrator)

    def prime(self, state: State) -> State:
        self._check(state)
        return integrators.prime(state, self.acc_fn)

    def step(self, state: State, dt) -> State:
        self._check(state)
        return self._stepper(state, dt, self.acc_fn)


def shard_state(mesh: Mesh, state: State) -> State:
    """This rank's rows of a whole state (host or device), copied onto the
    rank's device; the 0-d fields (time, n_active) are copied whole."""
    n = state.pos.shape[0]
    check_divisible(n, mesh)
    rows = n // mesh.size
    lo = mesh.rank * rows

    def take(v):
        if v is None:
            return None
        v = torch.as_tensor(v)
        if v.dim() >= 1 and v.shape[0] == n:
            v = v[lo:lo + rows]
        return v.to(mesh.device, copy=True)

    return State(**{f: take(getattr(state, f)) for f in State._fields})


def all_reduce(t, op, mesh: Mesh):
    """`t` reduced in place over the group by `op`, and returned (a
    collective)."""
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def all_gather_rows(t, mesh: Mesh):
    """The ranks' tensors of one shape, concatenated in rank order along
    dim 0 (a collective). At D = 1 the tensor itself."""
    if mesh.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def gather_state(mesh: Mesh, state: State) -> State:
    """The whole state in user order, on every rank (a collective: every
    rank calls it). The shards are contiguous runs of rows, so user order
    is rank order. At D = 1 the state itself."""
    if mesh.size == 1:
        return state
    rows = state.pos.shape[0]

    def gather(v):
        if v is None or v.dim() == 0 or v.shape[0] != rows:
            return v
        return all_gather_rows(v, mesh)

    return State(**{f: gather(getattr(state, f)) for f in State._fields})
