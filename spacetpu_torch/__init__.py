"""spacetpu_torch — the gravitational N-body engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package `spacetpu`, which stays the reference. This
package imports neither JAX nor anything of `spacetpu`. Its entry points
run on the card unless the caller passes ``device="cpu"``. Ported: the direct
all-pairs solver, the Barnes-Hut tree (two and three far-field levels,
equal-count and adaptive clusters, direct or hybrid near sums) and the mesh
families, particle-mesh and TreePM. The engine, render, the extra physics,
strip mode on the card and the multi-device solvers are not ported yet (see
ROADMAP.md).
"""

from spacetpu_torch import constants
from spacetpu_torch.sim import (SimConfig, Simulation, make_simulation,
                                reference_compatible)
from spacetpu_torch.state import Body, Scene, State, make_state
from spacetpu_torch.utils.metrics import ElapsedTime, compute_elapsed_time

__version__ = "0.1.0"

__all__ = [
    "Body",
    "ElapsedTime",
    "Scene",
    "SimConfig",
    "Simulation",
    "State",
    "compute_elapsed_time",
    "constants",
    "make_simulation",
    "make_state",
    "reference_compatible",
]
