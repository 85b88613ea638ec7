"""Checkpoint and resume of simulation state (npz).

The counterpart of `spacetpu/io/checkpoint.py`, in the same file format:
each State field as ``state_<field>``, the scene's host metadata
(``scene_colors``, ``scene_radii``, ``scene_names``, ``scene_g``) and a JSON
``extra_json``. So a checkpoint of the JAX package loads here and one of
the port loads there; with `state.state_from_numpy` this is how a JAX run's
state carries across to the port.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from spacetpu_torch.state import Scene, State, resolve_device

_FIELDS = ("pos", "vel", "mass", "acc", "pos_c", "vel_c", "time", "n_active")

#: the ROADMAP.md item that ports the sharded checkpoints
_SHARDED = "ROADMAP.md Queue A item 11 (multi-device)"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def save(path: str, state: State, *, scene: Optional[Scene] = None,
         extra: Optional[dict] = None):
    """Write state (+ optional scene metadata and JSON extras) to an npz.
    Reads the state back from the device."""
    arrays = {}
    for f in _FIELDS:
        v = getattr(state, f)
        if v is not None:
            arrays[f"state_{f}"] = (v.detach().cpu().numpy()
                                    if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
    if scene is not None:
        arrays["scene_colors"] = scene.colors
        arrays["scene_radii"] = scene.radii
        arrays["scene_names"] = np.array(scene.names)
        arrays["scene_g"] = np.float64(scene.g)
    if extra:
        arrays["extra_json"] = np.array(json.dumps(extra))
    np.savez_compressed(path, **arrays)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def load(path: str, *, dtype=None, device=None):
    """Read back (state, scene | None, extra | None), the state on `device`
    (the card unless named). dtype (a torch or numpy float type, or its
    name) overrides the stored float dtype."""
    dev = resolve_device(device)
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = _DTYPES[np.dtype(dtype).name]
    with np.load(path, allow_pickle=False) as z:
        kw = {}
        for f in _FIELDS:
            key = f"state_{f}"
            if key not in z:
                kw[f] = None
                continue
            t = torch.from_numpy(np.array(z[key]))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            kw[f] = t.to(dev)
        state = State(**kw)
        scene = None
        if "scene_colors" in z:
            # the real body count is the metadata length: state rows may
            # be padded, so trim the scene's copies to it
            n = len(z["scene_names"])
            scene = Scene(
                names=[str(s) for s in z["scene_names"]],
                colors=z["scene_colors"],
                radii=z["scene_radii"],
                pos=_f64(state.pos)[:n],
                vel=_f64(state.vel)[:n],
                mass=_f64(state.mass)[:n],
                g=float(z["scene_g"]) if "scene_g" in z else Scene.g,
            )
        extra = None
        if "extra_json" in z:
            extra = json.loads(str(z["extra_json"]))
    return state, scene, extra


def save_orbax(path: str, state: State, *, extra: Optional[dict] = None):
    """Not ported: the sharded, asynchronous checkpoints go with the
    multi-device solvers. Use `save`."""
    raise NotImplementedError(
        f"orbax checkpoints are not ported yet: {_SHARDED}; use save()")


def load_orbax(path: str, *, like: Optional[State] = None):
    """Not ported (see `save_orbax`). Use `load`."""
    raise NotImplementedError(
        f"orbax checkpoints are not ported yet: {_SHARDED}; use load()")
