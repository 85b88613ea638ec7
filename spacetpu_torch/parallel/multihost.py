"""Start-up of a `torch.distributed` group: one rank a device (PyTorch).

The counterpart of `spacetpu/parallel/multihost.py`. Every rank joins one
process group before it touches a device; the sharded solvers then talk
over it (NCCL between cards, gloo between CPU processes):

    from spacetpu_torch.parallel import multihost, ring
    multihost.initialize()          # env-driven; no-op single-process
    mesh = ring.make_mesh()         # the group: its size and this rank
    sim = ring.ShardedSimulation(mesh, n, ...)

The settings come from the arguments, else torchrun's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), else the JAX
package's names (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID). There is no discovery of a cluster: without an address
`initialize` does nothing and returns False. `local_group` forms a group
of one rank on a free local port (``--shard 1`` without a coordinator),
and `launch` starts the ranks of a group on this host, each with its own
time limit, so that a rank that dies or hangs fails the launch instead of
waiting forever.
"""

from __future__ import annotations

import datetime
import inspect
import os
import pathlib
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

#: seconds that a rendezvous, a collective or a launched rank may take
TIMEOUT_S = 120.0

#: the device of this rank, set by `initialize`
_device: torch.device | None = None

_PKG_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _env_int(*names) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def settings(coordinator_address=None, num_processes=None, process_id=None,
             local_device_ids=None) -> dict | None:
    """The group's settings, {"address", "world", "rank", "local"}, each
    from its argument, else torchrun's variable, else the JAX package's; or
    None where no address is set anywhere. ``local`` is this rank's card:
    the first of `local_device_ids`, else LOCAL_RANK, else the rank modulo
    the cards here (0 without a card)."""
    env = os.environ
    if coordinator_address is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or None
    if coordinator_address is None:
        return None
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the number "
            "of processes and this process's id (there is no discovery of "
            "a cluster: pass them, or set WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside a group of "
                         f"{num_processes}")
    if local_device_ids:
        local = int(list(local_device_ids)[0])
    else:
        local = _env_int("LOCAL_RANK")
        if local is None:
            cards = torch.cuda.device_count()
            local = process_id % cards if cards else 0
    return {"address": coordinator_address, "world": int(num_processes),
            "rank": int(process_id), "local": local}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None, *,
               device=None) -> bool:
    """Join the process group. Returns True if this process is in one (now
    or already), False where no setting names a coordinator (a
    single-process run).

    The backend is NCCL where the rank has a card (`device` None or a CUDA
    device; the card is pinned with `torch.cuda.set_device` before any
    allocation) and gloo on the CPU (``device="cpu"``, or no card)."""
    global _device
    if dist.is_initialized():
        return True
    s = settings(coordinator_address, num_processes, process_id,
                 local_device_ids)
    if s is None:
        return False
    want_cuda = (torch.cuda.is_available() if device is None
                 else torch.device(device).type == "cuda")
    kw = {}
    if want_cuda:
        torch.cuda.set_device(s["local"])
        dev = torch.device("cuda", s["local"])
        backend = "nccl"
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{s['address']}", world_size=s["world"],
        rank=s["rank"], timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **kw)
    _device = dev
    return True


def device() -> torch.device:
    """This rank's device: the card that `initialize` pinned, or the CPU
    under gloo."""
    if _device is not None:
        return _device
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def free_port() -> int:
    """A TCP port on the loopback address that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_group(device=None) -> bool:
    """Form a group of this one process on a free local port: NCCL on the
    current card, or gloo with ``device="cpu"``. Returns True where it
    formed one (the caller ends it with `shutdown`), False where a group
    exists already."""
    if dist.is_initialized():
        return False
    local = None
    if device is None or torch.device(device).type == "cuda":
        local = [torch.cuda.current_device()]
    return initialize(f"127.0.0.1:{free_port()}", 1, 0, local, device=device)


def shutdown() -> None:
    """Leave and destroy the process group, if there is one."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def launch(cmd, n: int, *, timeout: float = TIMEOUT_S) -> list[str]:
    """Run `cmd` (an argv list) as the n ranks of a group on this host and
    return each rank's output (stdout and stderr). Each rank finds the
    group through torchrun's variables on a free loopback port, with
    LOCAL_RANK its rank, and imports this package from this checkout.
    Raises RuntimeError, with every rank's output, where a rank exits
    nonzero or the ranks are not done within `timeout` seconds (then all
    are killed)."""
    port = free_port()
    path = os.pathsep.join(p for p in (str(_PKG_ROOT),
                                       os.environ.get("PYTHONPATH")) if p)
    procs, files = [], []
    try:
        for r in range(n):
            f = tempfile.TemporaryFile(mode="w+")
            files.append(f)
            e = dict(os.environ, PYTHONPATH=path,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(list(cmd), stdout=f,
                                          stderr=subprocess.STDOUT, env=e))
        deadline = time.monotonic() + timeout
        late = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late or bad:
        what = (f"were not done within {timeout:g} s" if late
                else f"{bad} exited nonzero")
        raise RuntimeError(f"ranks of {' '.join(map(str, cmd))}: {what}\n"
                           + "\n".join(f"--- rank {r} ---\n{o}"
                                       for r, o in enumerate(outs)))
    return outs

