"""Checkpoint and resume of simulation state (npz).

The counterpart of `spacetpu/io/checkpoint.py`, in the same file format:
each State field as ``state_<field>``, the scene's host metadata
(``scene_colors``, ``scene_radii``, ``scene_names``, ``scene_g``) and a JSON
``extra_json``. So a checkpoint of the JAX package loads here and one of
the port loads there; with `state.state_from_numpy` this is how a JAX run's
state carries across to the port.

`save_orbax` and `load_orbax` keep the JAX package's names for its
sharded checkpoints, in this package's own format: a directory of
`torch.distributed.checkpoint`, where each rank of a sharded state writes
and reads its own rows, and a ``<path>.extra.json`` beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from spacetpu_torch.state import Scene, State, resolve_device

_FIELDS = ("pos", "vel", "mass", "acc", "pos_c", "vel_c", "time", "n_active")

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


def _orbax_extra_path(path) -> str:
    return str(path).rstrip("/") + ".extra.json"


def save_orbax(path: str, state: State, *, extra: Optional[dict] = None,
               mesh=None):
    """Write state to the directory `path` with `torch.distributed.
    checkpoint`; `extra`, as JSON, to ``<path>.extra.json``.

    With `mesh` (a `parallel.ring.Mesh`), `state` is this rank's shard of a
    sharded state: its row fields are saved as DTensors sharded on their
    first dim over the group, so each rank writes its own rows and nothing
    is gathered; every rank of the group calls this. Without `mesh` this
    process writes the whole state alone. The name is the JAX
    package's; the format is this package's own (a checkpoint does not
    cross between the packages; `save` does)."""
    import torch.distributed.checkpoint as dcp

    payload = {}
    dmesh = None if mesh is None else _device_mesh(mesh)
    for f in _FIELDS:
        v = getattr(state, f)
        if v is None:
            continue
        if mesh is not None and v.dim() >= 1:
            v = _row_sharded(v, mesh, dmesh)
        payload[f] = v
    # a whole state is written by this process alone, group or not
    with _quiet_alone():
        dcp.save(payload, checkpoint_id=str(path), no_dist=mesh is None,
                 process_group=None if mesh is None else mesh.group)
    if extra and (mesh is None or mesh.rank == 0):
        with open(_orbax_extra_path(path), "w") as fh:
            json.dump(extra, fh)


@contextlib.contextmanager
def _quiet_alone():
    """Silence the warning that `torch.distributed.checkpoint` gives for a
    read or write by one process, which is what ``no_dist`` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _device_mesh(mesh):
    """The DeviceMesh of `mesh`'s own group (the default group where it
    names none), the group that `torch.distributed.checkpoint` is given:
    built from the group, so a subgroup's ranks alone take part."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(mesh.group or dist.group.WORLD,
                                 mesh.device.type)


def _row_sharded(local: torch.Tensor, mesh, dmesh):
    """The DTensor whose shard on this rank is `local`, sharded on dim 0
    over `dmesh`, `mesh`'s DeviceMesh."""
    from torch.distributed.tensor import DTensor, Shard

    shape = (local.shape[0] * mesh.size,) + tuple(local.shape[1:])
    return DTensor.from_local(local.contiguous(), dmesh,
                              [Shard(0)], run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def load_orbax(path: str, *, like: Optional[State] = None, mesh=None,
               device=None) -> "tuple[State, Optional[dict]]":
    """Read a `save_orbax` checkpoint back -> (state, extra). Like the JAX
    package's, it carries no scene metadata.

    like: a State whose fields give the shapes and dtypes to restore into.
    With `mesh` too, `like` is this rank's shard of a live sharded state and
    each rank reads only its own rows onto its device (every rank calls
    this). Without `like` the whole state is read onto `device` (the card
    unless named)."""
    import torch.distributed.checkpoint as dcp

    if like is None:
        dev = resolve_device(device)
        meta = dcp.FileSystemReader(str(path)).read_metadata()
        target = {}
        for f, m in meta.state_dict_metadata.items():
            target[f] = torch.empty(tuple(m.size), dtype=m.properties.dtype,
                                    device=dev)
    else:
        target = {}
        dmesh = None if mesh is None else _device_mesh(mesh)
        for f in _FIELDS:
            v = getattr(like, f)
            if v is None:
                continue
            v = torch.empty_like(v)
            if mesh is not None and v.dim() >= 1:
                v = _row_sharded(v, mesh, dmesh)
            target[f] = v
    sharded = like is not None and mesh is not None
    with _quiet_alone():
        dcp.load(target, checkpoint_id=str(path), no_dist=not sharded,
                 process_group=mesh.group if sharded else None)
    kw = {f: None for f in _FIELDS}
    for f, v in target.items():
        kw[f] = v.to_local() if hasattr(v, "to_local") else v
    extra = None
    if os.path.exists(_orbax_extra_path(path)):
        with open(_orbax_extra_path(path)) as fh:
            extra = json.load(fh)
    return State(**kw), extra
