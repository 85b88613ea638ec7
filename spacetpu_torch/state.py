"""SoA simulation state and host-side scene metadata (PyTorch).

The counterpart of `spacetpu/state.py`: a `State` is a NamedTuple of dense
tensors with the same fields, built by `make_state` from host arrays. The
entry points put it on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from spacetpu_torch import constants


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is no
    card: nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class State(NamedTuple):
    """N-body system state as dense tensors.

    ``pos``/``vel`` are ``(N, 3)``, ``mass`` is ``(N,)``. ``acc`` caches
    the acceleration at ``pos`` so leapfrog needs one force pass per step.
    ``pos_c``/``vel_c`` are optional Neumaier compensation terms, or None.
    ``time`` is a 0-d tensor of elapsed time; ``n_active`` the number of
    real bodies (rows at and above it are zero-mass padding).
    """

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    acc: torch.Tensor
    pos_c: Any = None
    vel_c: Any = None
    time: Any = None
    n_active: Any = None

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def _copy(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def make_state(
    pos,
    vel,
    mass,
    *,
    dtype=torch.float32,
    compensated: bool = False,
    pad_to: int | None = None,
    device=None,
) -> State:
    """Build a State from array-likes (copied), padding N up to ``pad_to``
    with zero-mass bodies parked at the origin."""
    dev = resolve_device(device)
    pos = _copy(pos, dtype, dev)
    vel = _copy(vel, dtype, dev)
    mass = _copy(mass, dtype, dev)
    n = pos.shape[0]
    if pos.shape != (n, 3) or vel.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(
            f"bad shapes pos={tuple(pos.shape)} vel={tuple(vel.shape)} "
            f"mass={tuple(mass.shape)}"
        )
    if pad_to is not None and pad_to > n:
        pad = pad_to - n
        pos = torch.cat([pos, pos.new_zeros((pad, 3))])
        vel = torch.cat([vel, vel.new_zeros((pad, 3))])
        mass = torch.cat([mass, mass.new_zeros((pad,))])
    return State(
        pos=pos,
        vel=vel,
        mass=mass,
        acc=torch.zeros_like(pos),
        pos_c=torch.zeros_like(pos) if compensated else None,
        vel_c=torch.zeros_like(vel) if compensated else None,
        time=pos.new_zeros(()),
        n_active=torch.tensor(n, dtype=torch.int32, device=dev),
    )


def state_from_numpy(d: dict, *, device=None, dtype=None) -> State:
    """A State from the fields of a `spacetpu` State given as numpy arrays
    (``{k: np.asarray(v) for k, v in s._asdict().items() if v is not None}``).
    Floating fields take ``dtype`` (default: their own); ``n_active`` stays
    int32. Missing fields are None."""
    dev = resolve_device(device)
    out = {}
    for name in State._fields:
        if name not in d or d[name] is None:
            out[name] = None
        else:
            kind = torch.int32 if name == "n_active" else dtype
            out[name] = _copy(d[name], kind, dev)
    return State(**out)


@dataclasses.dataclass
class Scene:
    """Host-side per-body metadata and the initial state, in numpy."""

    names: list[str]
    colors: np.ndarray  # (N, 3) f32
    radii: np.ndarray  # (N,) f32
    pos: np.ndarray  # (N, 3) f64
    vel: np.ndarray  # (N, 3) f64
    mass: np.ndarray  # (N,) f64
    #: gravitational constant of the scene's unit system
    g: float = constants.G

    @property
    def n(self) -> int:
        return len(self.names)

    def state(self, *, dtype=torch.float32, compensated=False, pad_to=None,
              device=None) -> State:
        return make_state(
            self.pos,
            self.vel,
            self.mass,
            dtype=dtype,
            compensated=compensated,
            pad_to=pad_to,
            device=device,
        )

    @staticmethod
    def from_bodies(bodies: Sequence["Body"]) -> "Scene":
        return Scene(
            names=[b.name for b in bodies],
            colors=np.array([b.color for b in bodies], np.float32).reshape(-1, 3),
            radii=np.array([b.radius for b in bodies], np.float32),
            pos=np.array([b.pos for b in bodies], np.float64).reshape(-1, 3),
            vel=np.array([b.vel for b in bodies], np.float64).reshape(-1, 3),
            mass=np.array([b.mass for b in bodies], np.float64),
        )


@dataclasses.dataclass
class Body:
    """One named body: pos in AU, vel in AU/s, mass in Earth masses, color
    RGB in [0, 1], radius in AU."""

    name: str
    pos: tuple[float, float, float]
    vel: tuple[float, float, float]
    mass: float
    color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    radius: float = 1e4 / 1.495e11
