"""spacetpu_torch — the gravitational N-body engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package `spacetpu`, which stays the reference. This
package imports neither JAX nor anything of `spacetpu`. Its entry points
run on the card unless the caller passes ``device="cpu"`` (or, on the
command line, ``--platform cpu``). Ported: the direct all-pairs solver, the
Barnes-Hut tree (two and three far-field levels, equal-count and adaptive
clusters, the near phase as pair lists or strips, direct or hybrid near
sums), the mesh families, particle-mesh and
TreePM, the engine (`engine`: the sim thread, the exchange, the solver
auto-select and its mid-run fallback), the app (`main`, ``python -m
spacetpu_torch``, with `utils/config` and the npz checkpoints of
`io/checkpoint`) and render (`render/`: camera, trails, the scatter and
ordered renderers, the tile splatter with its CUDA kernel, the fused frame
and the offline, terminal and window frontends), the extra physics
(multirate substeps, encounter reports and collision merging), multi-device
(`parallel/`: the body-sharded direct ring, the sharded particle-mesh, the
sharded Barnes-Hut tree with its halo exchange (`parallel/tree2.py`), the
sharded TreePM (`parallel/treepmshard.py`), the distributed bitonic sort,
the start-up of a `torch.distributed` group, one rank a device, ``--shard``
and ``--coordinator``, the sharded checkpoints), and `native`, the float64
C++ oracle that the tests hold the solvers against.
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
