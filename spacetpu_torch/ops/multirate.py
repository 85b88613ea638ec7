"""Two-level multirate (block-timestep) leapfrog (PyTorch).

The counterpart of `spacetpu/ops/multirate.py`. Per outer step of ``dt``
with ``substeps = m`` and a fast set of ``F`` bodies:

1. one full force pass per outer step (the cached ``state.acc``), as plain
   leapfrog takes;
2. the F bodies with the smallest dynamical time ``tau = |v| / |a|`` form
   the fast set (`torch.topk`, chosen anew every step, nothing read back);
3. slow bodies take the standard KDK step, so their position at a time
   ``t`` inside the step is ``pos + v_half * t``;
4. fast bodies take m KDK substeps of ``h = dt / m``; each substep's force
   is a rectangular pass of the F fast targets against all N sources, the
   slow ones on their drift line and the fast ones at their substep
   positions: ``(m - 1) F N`` pairs, not ``(m - 1) N^2``;
5. the last substep's force is the end-of-step full pass (every source is
   at its final position), so one ``acc_fn`` call closes the slow bodies'
   second kick and the fast bodies' last half kick, and refills the cache.

``F = N`` is m plain leapfrog steps of ``dt / m`` (to rounding), and
``m = 1`` plain leapfrog at ``dt``. For ``F < N`` the slow bodies feel the
fast set's motion inside a step only through the endpoint kicks: momentum
is conserved to O(dt^3) a step, not to rounding. Neumaier compensation
(``pos_c``/``vel_c``) is carried through the slow step and the substeps.

Backends of the rectangular pass: "cuda" the hand-written ``direct_vpu``
kernel (`cuda_direct.acc_cross_kernel`, method "vpu", which slices the
source axis where the fast set alone cannot fill the card), "torch" the
plain `direct.acc_cross_chunked`, its sources in chunks so that the
(F, chunk) pair block stays near 2^28 elements, as the JAX package's XLA
path does.
"""

from __future__ import annotations

import torch

from spacetpu_torch.ops import cuda_direct, direct
from spacetpu_torch.ops.integrators import _cast, _comp_add
from spacetpu_torch.state import State

#: denominator floor for tau = v_eff / |a| (keeps 0/0 off padding rows)
_TINY = 1e-30


def dynamical_time(vel, acc):
    """Per-body timescale ``tau = (|v| + 1e-3 mean|v|) / |a|``; rows with
    v = 0 and a = 0 (padding) get +inf (slow). The speed floor keeps a body
    at a turning point, or a still central mass, from posting tau = 0."""
    v = torch.linalg.vector_norm(vel, dim=-1)
    a = torch.linalg.vector_norm(acc, dim=-1)
    v_eff = v + 1e-3 * torch.mean(v)
    tau = v_eff / (a + _TINY)
    return torch.where((v == 0) & (a == 0), torch.inf, tau)


def select_fast(state: State, cap: int) -> torch.Tensor:
    """Indices (int64) of the `cap` bodies with the smallest dynamical time,
    from the cached acceleration (no force pass). Padding rows (>=
    n_active) are forced slow. Ties may come out in another order than
    `jax.lax.top_k`'s; the set is the same."""
    tau = dynamical_time(state.vel, state.acc)
    if state.n_active is not None:
        rows = torch.arange(state.n, device=tau.device)
        tau = torch.where(rows < state.n_active, tau, torch.inf)
    return torch.topk(-tau, cap).indices


def cross_fn(backend: str, cap: int, *, softening: str, eps, g):
    """The rectangular pass ``(pos_t, pos_s, mass_s) -> acc`` of a backend:
    "cuda" the ``direct_vpu`` kernel, "torch" the chunked plain pass."""
    if backend == "cuda":
        def cross(pos_t, pos_s, mass_s):
            return cuda_direct.acc_cross_kernel(
                pos_t, pos_s, mass_s, softening=softening, eps=eps, g=g,
                method="vpu")
        return cross
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    # the (F, chunk) pair block stays near 2^28 elements
    chunk = max(1024, (1 << 28) // max(3 * cap, 1))

    def cross(pos_t, pos_s, mass_s):
        return direct.acc_cross_chunked(pos_t, pos_s, mass_s,
                                        softening=softening, eps=eps, g=g,
                                        chunk=chunk)
    return cross


def _put(x, idx, rows):
    """x[idx] = rows in place, where x (a tensor this step made) is not
    None."""
    if x is not None:
        x[idx] = rows


def step_multirate(state: State, dt, acc_fn, *, substeps: int, fast_cap: int,
                   softening: str, eps, g, backend: str = "torch") -> State:
    """One outer step of two-level multirate leapfrog (the module
    docstring). ``acc_fn(pos, mass) -> acc`` is the full force pass of any
    solver; the fast set's rectangular passes run on `backend` ("cuda" or
    "torch")."""
    m = int(substeps)
    cap = int(fast_cap)
    cross = cross_fn(backend, cap, softening=softening, eps=eps, g=g)
    dtype = state.pos.dtype
    dt = _cast(dt, dtype)
    # h rounded once in the state's dtype, as the JAX package divides
    h = float(torch.tensor(dt, dtype=dtype) / m)

    idx = select_fast(state, cap)

    # slow step, phase 1: the first kick (dt/2) and the linear drift law;
    # computed for every row, the fast rows replaced at the end
    v_half, vel_c = _comp_add(state.vel, state.vel_c, state.acc * (dt * 0.5))

    # the fast rows (and their compensation), first kick h/2 from the cache
    pos_f = state.pos[idx]
    vel_f = state.vel[idx]
    pc_f = None if state.pos_c is None else state.pos_c[idx]
    vc_f = None if state.vel_c is None else state.vel_c[idx]
    vel_f, vc_f = _comp_add(vel_f, vc_f, state.acc[idx] * (h * 0.5))

    for k in range(1, m):
        pos_f, pc_f = _comp_add(pos_f, pc_f, vel_f * h)
        # sources at t = k h: every body on its drift line, the fast rows
        # at their substep positions
        src = state.pos + v_half * _cast(k * h, dtype)
        src[idx] = pos_f
        vel_f, vc_f = _comp_add(vel_f, vc_f, cross(pos_f, src, state.mass)
                                * h)
    # the last drift to t = dt (for m == 1 the only one)
    pos_f, pc_f = _comp_add(pos_f, pc_f, vel_f * h)

    # one full pass closes the slow second kick (dt/2), the fast last half
    # kick (h/2) and the next step's cache
    pos1, pos_c = _comp_add(state.pos, state.pos_c, v_half * dt)
    _put(pos1, idx, pos_f)
    _put(pos_c, idx, pc_f)
    acc1 = acc_fn(pos1, state.mass)

    vel1, vel_c = _comp_add(v_half, vel_c, acc1 * (dt * 0.5))
    vel_f, vc_f = _comp_add(vel_f, vc_f, acc1[idx] * (h * 0.5))
    _put(vel1, idx, vel_f)
    _put(vel_c, idx, vc_f)
    return state._replace(
        pos=pos1, vel=vel1, acc=acc1, pos_c=pos_c, vel_c=vel_c,
        time=None if state.time is None else state.time + dt,
    )
