"""Physical and simulation constants (the values of `spacetpu.constants`).

Positions are in AU, masses in Earth masses and time in seconds, so the
gravitational constant is rescaled to ``G = G_ABS * M0 / AU**3``. The
comments beside each value in `spacetpu/constants.py` say where it comes
from and what it tunes.
"""

from __future__ import annotations

# --- Physical units ---
AU: float = 1.495e11
M0: float = 5.972e24
G_ABS: float = 6.674e-11
G: float = G_ABS * M0 / (AU * AU * AU)

# --- Simulation ---
DELTA: float = 10.0
#: the reference force law's denominator is ``r^3 + COLLISION_EPSILON``
COLLISION_EPSILON: float = 1e-15
CHECK_INTERVAL: int = 1
SYNC_EVERY: int = 8
TRAIL_MAX_LENGTH: int = 5
MIN_CIRCLE_SIZE: float = 0.05
#: `make_simulation(algorithm="auto")` picks the tree above this many bodies
BARNES_HUT_CUTOFF: int = 1000
MESH_SOLVER_CUTOFF: int = 500_000
INTERACTIVE_TREE_REFRESH: int = 8
MESH_RESOLVE_MASS_FRAC: float = 0.1
MESH_INTERACTIVE_GRID_MAX: int = 256
BARNES_HUT_THETA: float = 0.3
INTERACTIVE_TREE_THETA: float = 0.4
ENGINE_RECAL_EVERY: int = 400

# --- Time formatting ---
SEC_PER_HOUR: float = 60.0 * 60.0
SEC_PER_DAY: float = SEC_PER_HOUR * 24.0
SEC_PER_YEAR: float = 365.25 * SEC_PER_DAY
