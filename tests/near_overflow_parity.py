"""The tree's near-list overflow of one state, counted by both packages on
the CPU under the same caps.

    python tests/near_overflow_parity.py STATE.npz [--n-start 1000000]

STATE.npz holds `pos` and `mass` (as `chip_smoke.py --dump-headless`
writes the final state of `--frontend none --n 1000000 --steps 20`). Each
package builds the tree simulation of that headless run (theta 0.3, the
pair near phase, every other default), calibrates its caps on the start
state (`fixed_cloud(n_start)`, as the run's prime did; `recalibrate_every`
is 0, so they are not re-measured during the steps) and counts the
clusters over the near-list cap in STATE with `Simulation.health`. Prints
one JSON line: each package's caps and count, and whether they agree.
"""

import argparse
import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import spacetpu  # noqa: E402
import spacetpu_torch  # noqa: E402
from spacetpu.models import presets as jpresets  # noqa: E402
from spacetpu_torch.models import presets as tpresets  # noqa: E402

SIM = dict(algorithm="tree", theta=0.3, near_mode="pairs")
CAPS = ("k_near", "near_tiles", "near_tiles_q", "k_super")


def count_jax(start, pos, mass) -> dict:
    sim = spacetpu.make_simulation(start.n, **SIM)
    sim.calibrate(start.state(dtype=jnp.float32))
    state = start.state(dtype=jnp.float32)
    state = state._replace(pos=jnp.asarray(pos), mass=jnp.asarray(mass))
    health = sim.health(state)
    return {"caps": {k: sim.caps.get(k) for k in CAPS},
            "near_overflow": int(health["near_overflow"]),
            "clusters": int(health["clusters"])}


def count_torch(start, pos, mass) -> dict:
    sim = spacetpu_torch.make_simulation(start.n, device="cpu", **SIM)
    sim.calibrate(start.state(dtype=torch.float32, device="cpu"))
    state = start.state(dtype=torch.float32, device="cpu")
    state = state._replace(pos=torch.as_tensor(pos),
                           mass=torch.as_tensor(mass))
    health = sim.health(state)
    return {"caps": {k: sim.caps.get(k) for k in CAPS},
            "near_overflow": int(health["near_overflow"]),
            "clusters": int(health["clusters"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("state")
    ap.add_argument("--n-start", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    data = np.load(args.state)
    pos = data["pos"].astype(np.float32)
    mass = data["mass"].astype(np.float32)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    out = {"state": args.state, "n": int(pos.shape[0]),
           "jax": count_jax(jpresets.fixed_cloud(args.n_start), pos, mass),
           "torch": count_torch(tpresets.fixed_cloud(args.n_start), pos,
                                mass)}
    out["agree"] = (out["jax"]["near_overflow"]
                    == out["torch"]["near_overflow"]
                    and out["jax"]["caps"] == out["torch"]["caps"])
    print(json.dumps(out), flush=True)
    return 0 if out["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
