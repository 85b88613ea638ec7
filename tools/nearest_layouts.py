#!/usr/bin/env python3
"""Time the layouts of `nearest_neighbor`'s band kernel on one card.

    python3 tools/nearest_layouts.py [--layouts 16x16x4,16x16x2,16x8x4,8x8x4]
        [--n 1000000] [--slots 16]

The band kernel of csrc/encounter.cu (`nn_band_kernel`) takes three
constants for float32: NN_P (rows a lane holds), NN_WARPS (warps a block)
and NN_UNROLL (columns a trip of its column loop), a layout
PxWARPSxUNROLL. For each layout the script builds a copy of csrc/ with
those set (nvcc, one process a library, started together), reports
ptxas' registers and spills and the pair loop's SASS
(`chip_smoke.sass_loops`) of the float32 band kernel, and times, by CUDA
events, the C entry `spacetpu_nearest_neighbor` (the diagonal tiles, the
bands of `energy.potential_bands` with `--slots` offsets, the join) on N
uniform random bodies in [-1, 1]^3, float32, every 62,500th dead, in two
rounds (in order, then reversed). Every layout must give the first
layout's table, bit for bit. One JSON line a layout, then a line with the
card's name and power limit. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def build(layouts, root: pathlib.Path) -> dict:
    """A library a layout: {key: (path, nvcc log)}."""
    from spacetpu_torch import _build

    src = (_build.CSRC / "encounter.cu").read_text()
    jobs = {}
    for key in layouts:
        p, w, u = (int(v) for v in key.split("x"))
        text = src
        for name, val in (("NN_P", p), ("NN_WARPS", w), ("NN_UNROLL", u)):
            text, k = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {val};", text)
            if k != 1:
                raise SystemExit(f"nearest_layouts: no {name} in encounter.cu")
        d = root / key
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "encounter.cu").write_text(text)
        out = d / "libencounter.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(out),
               str(d / "encounter.cu")]
        jobs[key] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for key, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nearest_layouts: nvcc failed for {key}:\n{log}")
        built[key] = (out, log)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="16x16x4,16x16x2,16x8x4,8x8x4")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--slots", type=int, default=16)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from spacetpu_torch.ops import energy

    if not torch.cuda.is_available():
        print("nearest_layouts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    layouts = args.layouts.split(",")
    built = build(layouts, HERE / ".archive" / "nearest_layouts")
    cuobjdump = str(pathlib.Path(__import__(
        "spacetpu_torch._build", fromlist=["nvcc"]).nvcc()).parent
        / "cuobjdump")
    n = args.n
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = (torch.rand(n, 3, device=dev, generator=gen) * 2 - 1).contiguous()
    alive = torch.ones(n, dtype=torch.uint8, device=dev)
    alive[::62_500] = 0
    P = ctypes.c_void_p
    rows_of = {}
    calls = {}
    for key, (path, log) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.spacetpu_nearest_neighbor.argtypes = [
            ctypes.c_int, P, P, P, P, ctypes.c_longlong, P, P, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), P]
        rows = int(key.split("x")[0]) * 32
        bands = energy.potential_bands(n, rows, args.slots)
        width = max((hi - lo + 1 for lo, hi in bands), default=0)
        flat = (ctypes.c_longlong * (2 * len(bands)))(
            *(d for b in bands for d in b))
        best = torch.empty(n, device=dev)
        idx = torch.empty(n, dtype=torch.int64, device=dev)
        wv = torch.empty((width, n), device=dev)
        wi = torch.empty((width, n), dtype=torch.int32, device=dev)

        def call(lib=lib, flat=flat, nb=len(bands), width=width, best=best,
                 idx=idx, wv=wv, wi=wi):
            launched = ctypes.c_int(0)
            rc = lib.spacetpu_nearest_neighbor(
                0, pos.data_ptr(), alive.data_ptr(), best.data_ptr(),
                idx.data_ptr(), n, wv.data_ptr(), wi.data_ptr(), width, flat,
                nb, ctypes.byref(launched),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"nearest_layouts: {key}: CUDA error {rc}")
            return best, idx

        calls[key] = call
        rows_of[key] = rows
    first = {}
    times = {key: [] for key in layouts}
    for order in (layouts, layouts[::-1]):
        for key in order:
            b, i = calls[key]()
            torch.cuda.synchronize()
            first.setdefault(key, (b.clone(), i.clone()))
            times[key].append(cs.cuda_ms(calls[key], 2))
    ref = first[layouts[0]]
    pairs = float(n) * (n - 1) / 2
    for key in layouts:
        path, log = built[key]
        found = [k for k in cs.ptxas_summary(log)
                 if "nn_band_kernelIf" in k["function"]]
        loops = cs.sass_loops(cuobjdump, str(path))
        loop = next((v for f, v in loops.items()
                     if "nn_band_kernelIf" in f and v), None)
        per_pair = (loop["instructions"]
                    / (int(key.split("x")[0]) * int(key.split("x")[2]))
                    if loop else None)
        issue = (None if per_pair is None else 1e3 * per_pair * pairs
                 / (card["sm_count"] * 4 * 32 * card["max_sm_mhz"] * 1e6))
        same = (torch.equal(first[key][0], ref[0])
                and torch.equal(first[key][1], ref[1]))
        print(json.dumps({"layout": key, "rows": rows_of[key], "ms": times[key],
                          "registers": found[0]["registers"] if found else None,
                          "spill_stores": found[0]["spill_stores"]
                          if found else None,
                          "loop": loop, "sass_per_pair": per_pair,
                          "issue_bound_ms": issue,
                          "same_bits_as_first": same}), flush=True)
        if not same:
            raise SystemExit(f"nearest_layouts: {key} differs from "
                             f"{layouts[0]}")
    print(json.dumps({"n": n, "slots": args.slots,
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
