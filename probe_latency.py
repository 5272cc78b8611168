#!/usr/bin/env python3
"""Measure, on one CUDA card, how many cycles one step of a dependent chain
takes for the operations the port's eliminations are built from: an f64
add, an f64 product and difference, an f64 division (with a zero numerator
too: the division's instruction sequence then takes its slow path), a
16-byte shared-memory load, a warp reduction, a 64-bit shuffle and a block
barrier.  Each kernel runs a chain of ITERS steps per thread and
reads ``clock64`` around it; the probe runs one warp alone and then
132 x 4 blocks of 96 threads (the GJ kernel's launch shape at n = 72) and
528 blocks of 192 threads, so that contention shows.

    python3 probe_latency.py

It builds its kernels with ``nvcc`` (the flags of ``ops/_build.py``) into
a temporary directory and needs a card.  The card's name and power limit
come first.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#define CHAIN(name, init, step, out)                                       \
  __global__ void name(double* o, long long* cyc, int iters, double x) {  \
    init;                                                                 \
    const long long t0 = clock64();                                       \
    for (int i = 0; i < iters; ++i) { step; }                             \
    const long long t1 = clock64();                                       \
    o[blockIdx.x * blockDim.x + threadIdx.x] = out;                       \
    if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;                      \
  }
CHAIN(k_dadd, double a = x + threadIdx.x, a = a + x, a)
CHAIN(k_dmul_dsub, double a = x + threadIdx.x, a = a - x * a, a)
CHAIN(k_ddiv, double a = x + threadIdx.x, a = a / x, a)
CHAIN(k_ddiv_zero, double a = 0.0 * x; double z = 0.0,
      a = z / (x + a), a)
__global__ void k_lds128(double* o, long long* cyc, int iters, double x) {
  __shared__ double2 s[16];
  if (threadIdx.x < 16) s[threadIdx.x] = make_double2(0.0, x);
  __syncthreads();
  int idx = 0;
  double acc = 0.0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const double2 v = s[idx];
    idx = static_cast<int>(v.x) + (i & 7);
    acc += v.y;
  }
  const long long t1 = clock64();
  o[blockIdx.x * blockDim.x + threadIdx.x] = acc + idx;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
CHAIN(k_redux, unsigned v = threadIdx.x,
      v = __reduce_max_sync(0xffffffffu, v + threadIdx.x), v)
CHAIN(k_shfl, double a = x + threadIdx.x,
      a = __shfl_sync(0xffffffffu, a, (threadIdx.x + 1) & 31), a)
__global__ void k_bar(double* o, long long* cyc, int iters, double x) {
  __shared__ int s[4];
  int v = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == 0) s[i & 3] = i;
    __syncthreads();
    v += s[i & 3];
  }
  const long long t1 = clock64();
  o[blockIdx.x * blockDim.x + threadIdx.x] = v;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
typedef void (*Kernel)(double*, long long*, int, double);
extern "C" int probe(int which, int blocks, int threads, int iters,
                     double* o, long long* cyc) {
  const Kernel ks[] = {k_dadd, k_dmul_dsub, k_ddiv, k_ddiv_zero, k_lds128,
                       k_redux, k_shfl, k_bar};
  ks[which]<<<blocks, threads>>>(o, cyc, iters, 1.0000001);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""

NAMES = ("f64 add", "f64 product and difference (2 operations)",
         "f64 division", "f64 division of zero", "16-byte shared load",
         "warp reduction (32-bit max)", "64-bit shuffle (2 shuffles)",
         "block barrier")
SHAPES = ((1, 32), (528, 96), (528, 192))
ITERS = 2048  # steps of each chain


def main():
    import torch

    from toyspice_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        lib_path = os.path.join(tmp, "probe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-o", lib_path,
                        src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.probe.restype = ctypes.c_int
        blocks = max(b for b, _ in SHAPES)
        out = torch.zeros(blocks * max(t for _, t in SHAPES),
                          dtype=torch.float64, device="cuda")
        cyc = torch.zeros(blocks, dtype=torch.int64, device="cuda")
        for which, name in enumerate(NAMES):
            cells = []
            for b, t in SHAPES:
                for _ in range(2):  # the first launch warms up
                    err = lib.probe(which, b, t, ITERS, out.data_ptr(),
                                    cyc.data_ptr())
                    if err != 0:
                        raise SystemExit(f"probe {name}: CUDA error {err}")
                per = float(cyc[:b].double().mean()) / ITERS
                cells.append(f"{b} x {t}: {per:.1f}")
            print(f"{name}: cycles a step ({'; '.join(cells)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
