#!/usr/bin/env python3
"""Time the multirate fast-set pass on one card.

    python3 tools/fast_pass.py [--shapes 128x262144,32768x262144]
        [--parent DIR] [--split-warps 32,64,256] [--reps 20]

The pass is `cuda_direct.acc_cross_kernel` with method "vpu" (the
`direct_vpu` kernels of csrc/direct.cu), M fast targets against all K
sources, in float32 under the plummer law at eps 1e-3 and g 1: the law of
the multirate scene (`chip_smoke.MULTIRATE`). The sources are
`chip_smoke.bodies(K)` and the targets their first M rows, as a fast set is
a subset of the bodies. For each shape MxK the script prints one JSON line:
the milliseconds a wrapper call by CUDA events over `--reps` calls, the
bound (M K pairs at 22 flops over 67e12 flop/s, `chip_smoke.FLOPS_PER_PAIR`),
the source slices the launch takes (`cuda_direct.vpu_slices`: 1 is the
plain grid), the largest difference from the plain version
(`acc_cross_plain`), whether two calls give the same bits, `entry_ms` (the
C entry alone, on inputs packed beforehand: its kernels on the card without
the wrapper's checks, packing and allocations) and `profile` (the card's
kernels of one wrapper call and their microseconds, `torch.profiler`; null
where the trace holds no device event).

Other builds of csrc/direct.cu are timed through their C entries alone, in
turns with this tree's (other, this, this, other): with `--split-warps`,
this tree's source with its SPLIT_WARPS constant (the warps an SM that the
source-split grid aims at) set to each value; with `--parent`, that tree's
direct.cu (the parent commit's, or any tree's, with or without the
source-split entry), with the largest difference from this tree's output and whether
the bits are the same. nvcc builds them all at once. A last line holds the
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
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

EPS = 1e-3
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong


def build_variants(split_warps, parent, root: pathlib.Path) -> dict:
    """{name: loaded library} of this tree's direct.cu with each SPLIT_WARPS
    value and of the parent's direct.cu, built in parallel into `root`."""
    from spacetpu_torch import _build

    source = (_build.CSRC / "direct.cu").read_text()
    sources = {}
    for warps in split_warps:
        text, n = re.subn(r"constexpr int64_t SPLIT_WARPS = \d+;",
                          f"constexpr int64_t SPLIT_WARPS = {warps};", source)
        if n != 1:
            raise SystemExit("fast_pass: direct.cu has no SPLIT_WARPS")
        sources[f"split_warps={warps}"] = (text, _build.CSRC)
    if parent:
        csrc = pathlib.Path(parent) / "spacetpu_torch" / "csrc"
        sources["parent"] = ((csrc / "direct.cu").read_text(), csrc)
    jobs = {}
    for name, (text, csrc) in sources.items():
        d = root / name.replace("=", "_")
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "direct.cu").write_text(text)
        so = d / "direct.so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(so), str(d / "direct.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"fast_pass: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        # a direct.cu from before the source-split grid has no slices entry
        lib.split_grid = hasattr(lib, "spacetpu_direct_vpu_slices")
        if not lib.split_grid:
            lib.spacetpu_direct_vpu.argtypes = [
                ctypes.c_int, ctypes.c_int, _P, _P, _P, _I64, _I64,
                ctypes.c_double, _P]
        else:
            lib.spacetpu_direct_vpu.argtypes = [
                ctypes.c_int, ctypes.c_int, _P, _P, _P, _I64, _I64,
                ctypes.c_double, _P, _I64, _P]
            lib.spacetpu_direct_vpu_slices.argtypes = [
                ctypes.c_int, ctypes.c_int, _I64, _I64, ctypes.c_double]
            lib.spacetpu_direct_vpu_slices.restype = ctypes.c_longlong
        lib.spacetpu_direct_vpu.restype = ctypes.c_int
        libs[name] = lib
    return libs


def entry(lib, name, tgt, src):
    """(call, out, slices): a call of `lib`'s C entry alone on targets
    `tgt` and packed sources `src`, its output buffer and its slices, the
    scratch made beforehand."""
    import torch

    m, k = tgt.shape[0], src.shape[0]
    out = torch.empty_like(tgt)
    stream = torch.cuda.current_stream().cuda_stream
    work = None
    if not getattr(lib, "split_grid", True):
        args, slices = (), 1
    else:
        slices = lib.spacetpu_direct_vpu_slices(0, 0, m, k, EPS)
        work = tgt.new_empty((slices, m, 3))
        args = (work.data_ptr(), slices)

    def call():
        rc = lib.spacetpu_direct_vpu(0, 0, tgt.data_ptr(), src.data_ptr(),
                                     out.data_ptr(), m, k, EPS, *args, stream)
        if rc != 0:
            raise SystemExit(f"fast_pass: {name} launch failed: {rc}")
        return out

    call.work = work  # the scratch lives as long as the call
    return call, out, slices


def profile(fn) -> list | None:
    """(kernel name, microseconds) of each device event of one call of fn
    under torch.profiler, after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.name[:60], e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return events or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="128x262144,32768x262144",
                    help="comma-separated MxK")
    ap.add_argument("--parent", help="root of another tree whose direct.cu "
                    "is timed beside this one (the parent commit)")
    ap.add_argument("--split-warps", default="",
                    help="comma-separated SPLIT_WARPS values to build and "
                         "time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from spacetpu_torch import _build
    from spacetpu_torch.ops import cuda_direct

    if not torch.cuda.is_available():
        print("fast_pass: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    others = build_variants([int(w) for w in args.split_warps.split(",") if w],
                            args.parent, pathlib.Path(tmp.name))
    mine = _build.library("direct")
    kw = dict(softening="plummer", eps=EPS, g=1.0)
    for shape in args.shapes.split(","):
        m, k = (int(x) for x in shape.split("x"))
        pos, mass = cs.bodies(k, seed=k, dtype=torch.float32, dev=dev)
        tgt = pos[:m].contiguous()
        src = cuda_direct._pack_sources(pos, mass, 1.0)

        def wrapper():
            return cuda_direct.acc_cross_kernel(tgt, pos, mass, **kw)

        first, second = wrapper(), wrapper()
        plain = cuda_direct.acc_cross_plain(tgt, pos, mass, **kw)
        this, this_out, slices = entry(mine, "this", tgt, src)
        torch.cuda.synchronize()
        row = {"m": m, "k": k, "slices": slices,
               "bound_ms": 1e3 * m * k * cs.FLOPS_PER_PAIR["direct_vpu"]
               / cs.PEAK_F32_FLOPS,
               "max_abs_err": float((first - plain).abs().max()),
               "max_rel_err": float((first - plain).abs().max()
                                    / plain.abs().max()),
               "same_bits_twice": bool(torch.equal(first, second)),
               "ms": cs.cuda_ms(wrapper, args.reps),
               "entry_ms": cs.cuda_ms(this, args.reps),
               "profile": profile(wrapper)}
        row["ms_over_bound"] = row["entry_ms"] / row["bound_ms"]
        print(json.dumps(row), flush=True)
        for name, lib in others.items():
            other, out, other_slices = entry(lib, name, tgt, src)
            other()
            this()
            torch.cuda.synchronize()
            times = {name: [], "this": []}
            for turn in (name, "this", "this", name):
                times[turn].append(cs.cuda_ms(
                    other if turn == name else this, args.reps))
            print(json.dumps({
                "m": m, "k": k, "build": name, "slices": other_slices,
                "entry_ms": times,
                "max_abs_diff": float((out - this_out).abs().max()),
                "same_bits": bool(torch.equal(out, this_out))}), flush=True)
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
