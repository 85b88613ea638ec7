"""Step and render in one call: k physics steps, a trail push and a frame.

The counterpart of `spacetpu/render/fused.py`. The JAX version jits the
whole frame into one program with the state donated; here the same
sequence runs eagerly on the card (a CUDA graph of it is later work), and
the only host traffic is the finished framebuffer, when the caller reads
it.
"""

from __future__ import annotations

from typing import NamedTuple

from spacetpu_torch.render import fastsplat, trails
from spacetpu_torch.sim import Simulation
from spacetpu_torch.state import State


class FusedState(NamedTuple):
    sim_state: State
    trail_buf: trails.TrailBuffer


def make_fused_frame(sim: Simulation, *, width: int, height: int,
                     steps_per_frame: int = 1, trail_subdiv: int = 2,
                     exposure: float | None = None):
    """Return (init, frame) where frame(fused_state, dt, colors, radii,
    view, proj) -> (fused_state, framebuffer) runs everything on the
    simulation's device.

    exposure defaults to the N-scaled brightness the interactive viewer
    uses (min(1, 5000/N)) so dense clouds don't saturate to white."""
    if exposure is None:
        exposure = min(1.0, 5000.0 / max(sim.config.n, 1))

    def init(state: State, t: int = trails.TRAIL_MAX_LENGTH) -> FusedState:
        state = sim.prime(state)
        tb = trails.make_trails(state.n, t=t, dtype=state.pos.dtype,
                                device=state.pos.device)
        return FusedState(state, trails.push(tb, state.pos))

    def frame(fused: FusedState, dt, colors, radii_world, view, proj):
        # `sim.jit_epoch` and `sim.jit_consts` are what the JAX version
        # threads into its jitted frame so that a recalibration retraces
        # it; an eager step always reads the simulation's current tables
        state = fused.sim_state
        for _ in range(steps_per_frame):
            state = sim.traced_step(state, dt, sim.jit_consts)
        tb = trails.push(fused.trail_buf, state.pos)
        fb = fastsplat.render_scene_auto(
            tb.history, trails.ages(tb), colors, radii_world, view, proj,
            width=width, height=height, trail_subdiv=trail_subdiv,
            exposure=exposure)
        return FusedState(state, tb), fb

    return init, frame
