"""Symplectic integrators over the SoA state (PyTorch).

The counterpart of `spacetpu/ops/integrators.py`: semi-implicit Euler as
the reference integrates, leapfrog kick-drift-kick, and Yoshida's 4th-order
composition, each with optional Neumaier-compensated position and velocity
updates (when the state carries ``pos_c``/``vel_c``).

``dt`` is a number. It is rounded to the state's dtype first, as the JAX
package casts it, so every product below is the one the JAX package forms.
"""

from __future__ import annotations

from typing import Callable

import torch

from spacetpu_torch.state import State

AccFn = Callable[..., torch.Tensor]  # (pos, mass) -> acc

INTEGRATORS = ("euler", "leapfrog", "yoshida4")


def _cast(x, dtype) -> float:
    """The number `x` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(float(x), dtype=dtype))


def _comp_add(x, c, dx):
    """Neumaier-compensated x += dx. Returns (x, c) with c the running
    compensation carried into the next increment; with c=None a plain add.
    The |x| vs |y| select captures the rounding error also when |dx| > |x|."""
    if c is None:
        return x + dx, None
    y = dx + c
    t = x + y
    err = torch.where(torch.abs(x) >= torch.abs(y), (x - t) + y, (y - t) + x)
    return t, err


def step_euler(state: State, dt, acc_fn: AccFn) -> State:
    """Semi-implicit Euler, reference-compatible: one force pass at the
    current positions, then v += a*dt; x += v*dt."""
    dt = _cast(dt, state.pos.dtype)
    acc = acc_fn(state.pos, state.mass)
    vel, vel_c = _comp_add(state.vel, state.vel_c, acc * dt)
    pos, pos_c = _comp_add(state.pos, state.pos_c, vel * dt)
    return state._replace(
        pos=pos, vel=vel, acc=acc, pos_c=pos_c, vel_c=vel_c,
        time=None if state.time is None else state.time + dt,
    )


def step_leapfrog(state: State, dt, acc_fn: AccFn) -> State:
    """Leapfrog KDK: v += a(x)*dt/2; x += v*dt; v += a(x')*dt/2. The first
    kick uses the cached ``state.acc``, so a rollout starts with `prime`."""
    dt = _cast(dt, state.pos.dtype)
    half = dt * 0.5
    vel, vel_c = _comp_add(state.vel, state.vel_c, state.acc * half)
    pos, pos_c = _comp_add(state.pos, state.pos_c, vel * dt)
    acc = acc_fn(pos, state.mass)
    vel, vel_c = _comp_add(vel, vel_c, acc * half)
    return state._replace(
        pos=pos, vel=vel, acc=acc, pos_c=pos_c, vel_c=vel_c,
        time=None if state.time is None else state.time + dt,
    )


# Yoshida (1990) 4th-order coefficients: S(w1*dt) S(w0*dt) S(w1*dt).
_Y4_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y4_W0 = 1.0 - 2.0 * _Y4_W1


def step_yoshida4(state: State, dt, acc_fn: AccFn) -> State:
    """4th-order symplectic step: three leapfrog substeps with weights
    (w1, w0, w1); the middle one runs backwards. Time advances by exactly
    ``dt``. Same acc-cache contract as leapfrog."""
    dtype = state.pos.dtype
    dt = _cast(dt, dtype)
    t0 = state.time
    s = state if t0 is None else state._replace(time=None)
    for w in (_Y4_W1, _Y4_W0, _Y4_W1):
        s = step_leapfrog(s, dt * _cast(w, dtype), acc_fn)
    return s if t0 is None else s._replace(time=t0 + dt)


def prime(state: State, acc_fn: AccFn) -> State:
    """Populate ``state.acc`` with the acceleration at the current
    positions (needed before the first leapfrog step)."""
    return state._replace(acc=acc_fn(state.pos, state.mass))


def get_stepper(name: str):
    if name == "euler":
        return step_euler
    if name == "leapfrog":
        return step_leapfrog
    if name == "yoshida4":
        return step_yoshida4
    raise ValueError(f"unknown integrator {name!r} (want one of {INTEGRATORS})")
