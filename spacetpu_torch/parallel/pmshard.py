"""Body-sharded particle-mesh simulation over a group of ranks (PyTorch).

The counterpart of `spacetpu/parallel/pmshard.py`. Each rank CIC-deposits
its own shard of the bodies onto a compact (G+1)^3 mesh, one
`all_reduce(SUM)` makes the global mass mesh, and the FFT solve, the
gradient and the gather of the rank's own bodies run on every rank alike:
O(N/D) body work a rank and one mesh-sized collective a force pass. The
solve is replicated on purpose, as in the JAX package: at the supported
grids it takes milliseconds, less than a distributed FFT's transposes.

The façade is `ring.ShardedSimulation`'s: `shard_state`, `prime`
(calibrates, then fills the acc cache), `step`, `run`, `user_order`;
`health` and `maybe_recalibrate` carry the out-of-box count and the
rebuild. The calibration takes the box from an `all_reduce` of the
extent's MIN and MAX, so the cell size is the single-device one to the
bit; `health` sums the out-of-box counts over the ranks, so every rank
takes the same decision in `maybe_recalibrate`, which every rank calls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from spacetpu_torch import constants
from spacetpu_torch.ops import direct, integrators, pm
from spacetpu_torch.parallel import ring
from spacetpu_torch.state import State


class ShardedPMSimulation(ring.ShardedFacade):
    """Body-sharded PM N-body simulation: local deposit -> all_reduce of
    the mesh -> replicated FFT solve -> local gather."""

    def __init__(self, mesh: ring.Mesh, n: int, *, grid="auto",
                 margin: float = 2.0, softening: str = "plummer",
                 eps: float | None = None, g: float = constants.G,
                 integrator: str = "leapfrog"):
        ring.check_divisible(n, mesh)
        self.mesh = mesh
        self.n = n
        self.grid = pm.default_grid(n) if grid == "auto" else int(grid)
        self.margin = margin
        self.g = g
        self.eps, _ = direct._defaults(softening, eps, g)
        self._stepper = integrators.get_stepper(integrator)
        #: calibration products (box_min, h, grid, kernel_hat); None until
        #: calibrate() or prime() has seen a state
        self._pm: dict | None = None

    @property
    def mesh_params(self) -> dict | None:
        """The calibration (box_min, h, grid, kernel_hat), a snapshot; None
        before it."""
        return dict(self._pm) if self._pm else None

    def _all_reduce(self, t, op):
        return ring.all_reduce(t, op, self.mesh)

    def calibrate(self, state: State):
        """Measure the global bounding box (MIN and MAX of the local
        extents, in float64, over the group) and build the FFT'd kernel on
        every rank. A collective: every rank calls it."""
        pos = state.pos
        lo = self._all_reduce(pos.amin(dim=0).double(), dist.ReduceOp.MIN)
        hi = self._all_reduce(pos.amax(dim=0).double(), dist.ReduceOp.MAX)
        box_min, h = pm.box_from_extent(lo.cpu().numpy(), hi.cpu().numpy(),
                                        grid=self.grid, margin=self.margin)
        kernel_hat = pm.pm_kernel_hat(self.grid, h, eps=self.eps, g=self.g,
                                      dtype=pos.dtype, device=pos.device)
        self._pm = dict(box_min=box_min, h=h, grid=self.grid,
                        kernel_hat=kernel_hat)
        # on the device once: a tensor made from the host at every force
        # pass would make the host wait for the card there
        self._box = torch.as_tensor(box_min, dtype=pos.dtype,
                                    device=pos.device)

    def _local_acc(self, pos_l, mass_l):
        """Local deposit, one all_reduce, replicated solve, local gather."""
        p = self._pm
        if p is None:
            raise RuntimeError(
                "pm solver is uncalibrated: call prime() (or calibrate()) "
                "first; the mesh box and kernel are measured from the first "
                "state")
        box, inv_h = pm._scalars(pos_l, self._box, p["h"])
        mesh_l = pm.deposit_cic_compact(pos_l, mass_l.to(pos_l.dtype),
                                        box_min=box, inv_h=inv_h,
                                        grid=self.grid)
        mesh_g = self._all_reduce(mesh_l, dist.ReduceOp.SUM)
        return pm.acc_from_mesh_compact(pos_l, mesh_g,
                                        kernel_hat=p["kernel_hat"],
                                        box_min=box, inv_h=inv_h,
                                        grid=self.grid)

    def prime(self, state: State) -> State:
        self._check(state)
        if self._pm is None:
            self.calibrate(state)
        return integrators.prime(state, self._local_acc)

    def step(self, state: State, dt) -> State:
        self._check(state)
        return self._stepper(state, dt, self._local_acc)

    def health(self, state: State) -> dict:
        """The bodies outside the calibrated box, summed over the ranks, and
        the grid; {} before calibration. A collective."""
        if self._pm is None:
            return {}
        n_out = pm.count_out_of_box(state.pos, self._pm["box_min"],
                                    self._pm["h"], self.grid)
        n_out = self._all_reduce(n_out.to(torch.int64), dist.ReduceOp.SUM)
        return {"out_of_box": int(n_out), "grid": self.grid}

    def maybe_recalibrate(self, state: State, *, frac: float = 0.02) -> bool:
        """Re-measure the box and the kernel on every rank when more than
        `frac` of the bodies have left the calibrated box (their deposits
        are face-clamped until then: counted, never silent). The new box
        covers every body. A collective."""
        if self.health(state).get("out_of_box", 0) <= frac * self.n:
            return False
        self.calibrate(state)
        return True
