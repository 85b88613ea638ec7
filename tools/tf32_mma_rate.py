#!/usr/bin/env python3
"""The rate of mma.sync TF32 on one CUDA card: the tensor-core pipe's floor
of the float32 `direct_mxu` kernel (spacetpu_torch/csrc/direct.cu) is
counted at this rate.

    python3 tools/tf32_mma_rate.py       # about 20 s; needs nvcc and a card

Builds a probe into spacetpu_torch/_build/probes/ and times, between CUDA
events, m16n8k8 and m16n8k4 TF32 mma.sync (the kernel's two shapes):
eight independent accumulator chains a warp, 8 warps a block, two blocks
an SM. Prints one JSON line a shape with the clocks an instruction takes
on one SM sub-partition at the card's maximum SM clock, then the card's
name, power limit and SM clock.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spacetpu_torch import _build  # noqa: E402

PROBE = r'''
#include <cstdint>
#include <cuda_runtime.h>

template <int K8>
__global__ void __launch_bounds__(256, 2) mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a = threadIdx.x, b = threadIdx.x * 3;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (K8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a), "r"(a + c), "r"(a), "r"(b), "r"(b), "r"(a + c));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a), "r"(a + c), "r"(b));
    }
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c)
    for (int q = 0; q < 4; ++q) s += d[c][q];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int tf32_mma_rate(int k8, void* out, int blocks, int iters,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k8) mma_rate<1><<<blocks, 256, 0, s>>>(static_cast<float*>(out), iters);
  else mma_rate<0><<<blocks, 256, 0, s>>>(static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
'''

CHAINS = 8  # independent mma chains a warp


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "tf32_mma_rate.cu", out_dir / "tf32_mma_rate.so"
    cu.write_text(PROBE)
    r = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.tf32_mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    return lib


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = props.multi_processor_count
    blocks, iters = 2 * sms, 20_000
    buf = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(k8):
        rc = lib.tf32_mma_rate(k8, buf.data_ptr(), blocks, iters, stream)
        if rc:
            raise SystemExit(f"tf32_mma_rate: CUDA error {rc}")

    for k8, shape in ((1, "m16n8k8"), (0, "m16n8k4")):
        run(k8)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(2):
            run(k8)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 2
        # 8 warps a block, each issuing CHAINS mma an iteration, spread over
        # the 4 sub-partitions of each SM
        per_subpartition = blocks * 8 * iters * CHAINS / (sms * 4)
        print(json.dumps({"mma_tf32": shape, "ms": ms,
                          "clocks_each_at_max_sm_clock":
                          ms * 1e-3 * clock_hz / per_subpartition}),
              flush=True)
    print(smi("name,power.limit,clocks.sm"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
