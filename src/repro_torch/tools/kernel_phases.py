"""Where the tensor-core kernels spend their cycles, on the card.

    PYTHONPATH=src python -m repro_torch.tools.kernel_phases

Builds with nvcc (into ``build/tools/``) and runs two plain CUDA programs,
with no PyTorch in them:

1. **The m16n8k8 TF32 rate**: one ``mma.sync`` chain or several
   independent ones per warp, one to sixteen warps per SM on all 132 SMs;
   prints cycles per step per warp and per SM (``clock64``).
2. **Phase profiles** of ``csrc/flash_attention.cu`` at the Qwen2 wave's
   larger prefill (q (4, 96, 14, 64), causal) and ``csrc/ssd_scan.cu`` at
   the Mamba2 wave's (x (3, 256, 24, 64), chunk 128): a copy of each
   kernel with ``clock64`` stamps between its phases (lane 0 of every
   warp; each stamp first waits on the phase's last result), run five
   times on fixed inputs; prints each launch's ms (CUDA events) and, for
   a few blocks, every warp's cycles per phase from the last run.

The copies are made from the sources by inserting stamps at fixed lines;
if a source changes so that a line is not found, the script says which.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

from ..kernels.build import ARCH, CSRC

OUT = Path(__file__).resolve().parents[3] / "build" / "tools"

STAMP = """
__device__ long long g_prof[4096][20];
#define STAMP(i, dep) do { if ((dep) == 12345.678f) g_prof[0][0] = 1; \\
    if ((threadIdx.x & 31) == 0) g_prof[pidx][i] = clock64(); } while (0)
"""

HMMA_RATE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int C>
__global__ void chains(float* out, long long* cyc, int iters) {
  float d[C][4];
  for (int c = 0; c < C; ++c)
    d[c][0] = d[c][1] = d[c][2] = d[c][3] = threadIdx.x * 1e-3f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, 3u, 5u};
  uint32_t b[2] = {7u, threadIdx.x};
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  long long t1 = clock64();
  float s = 0;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int C>
void run(int warps, float* out, long long* cyc) {
  const int iters = 2000;
  chains<C><<<132, 32 * warps>>>(out, cyc, iters);
  cudaDeviceSynchronize();
  long long h;
  cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
  const double per_warp = double(h) / (C * iters);
  printf("hmma rate: %d chain(s) per warp, %2d warps per SM: %.2f cycles "
         "per step per warp, %.2f per SM\n", C, warps, per_warp,
         per_warp / warps);
}
int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 132 * 1024 * 4);
  cudaMalloc(&cyc, 132 * 8);
  for (int w : {1, 4, 8, 16}) {
    run<1>(w, out, cyc);
    run<2>(w, out, cyc);
    run<4>(w, out, cyc);
    run<8>(w, out, cyc);
  }
  printf("hmma rate: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""

# (source, [(line to find, text inserted before it or, with "+", after)])
FLASH_STAMPS = [
    ("  const int64_t i0 = r0 + g, i1 = i0 + 8; // the lane's two rows\n",
     "+  const int pidx = (blockIdx.x * gridDim.y + blockIdx.y) * 4 + warp;\n"
     "  STAMP(0, 0.f);\n"),
    ("  float acc[KT][4];\n", "  STAMP(1, qf[KT - 1][3]);\n"),
    ("    const bool live = r0 < Sq", "    if (it == 0) STAMP(2, 0.f);\n"),
    ("      const bool need_mask =", "      if (it == 0) STAMP(3, s[NT - 1][3]);\n"),
    ("        const FragA pa = acc_as_a(s[j]);",
     "+        if (it == 0 && j == 0) STAMP(4, s[NT - 1][3]);\n"),
    ("    __syncthreads();   // every warp is done with this stage\n",
     "    if (it == 0) STAMP(5, acc[KT - 1][3]);\n"),
    ("  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);\n",
     "  STAMP(6, acc[KT - 1][3]);\n"),
]
FLASH_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int B = 4, S = 96, H = 14, KV = 2, D = 64;
  const size_t nq = size_t(B) * S * H * D, nk = size_t(B) * S * KV * D;
  std::vector<float> hq(nq), hk(nk);
  for (size_t i = 0; i < nq; ++i) hq[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < nk; ++i) hk[i] = (i * 40503u % 1000) / 1e3f - .5f;
  float *q, *k, *v, *o;
  cudaMalloc(&q, nq * 4); cudaMalloc(&k, nk * 4); cudaMalloc(&v, nk * 4);
  cudaMalloc(&o, nq * 4);
  cudaMemcpy(q, hq.data(), nq * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(k, hk.data(), nk * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(v, hk.data(), nk * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = flash_attention_launch(
        q, k, v, o, B, S, S, H, KV, D, S * H * D, H * D, D, S * KV * D,
        KV * D, D, S * KV * D, KV * D, D, 1, 0, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("flash phases: launch %d rc %d, %.4f ms\n", rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  for (int bx : {0, 55}) for (int by = 0; by < 2; ++by)
    for (int w = 0; w < 4; ++w) {
      const long long* t = hp[(bx * 2 + by) * 4 + w];
      if (t[3] == 0) {
        printf("flash phases: block (%d, %d) warp %d: no row of the warp "
               "is in range, %lld cycles in all\n", bx, by, w, t[6] - t[0]);
        continue;
      }
      printf("flash phases: block (%d, %d) warp %d cycles: Q load %lld, "
             "first K/V tile %lld, S = Q K^T %lld, softmax %lld, P V %lld, "
             "later tiles and epilogue %lld, total %lld\n", bx, by, w,
             t[1] - t[0], t[2] - t[1], t[3] - t[2], t[4] - t[3],
             t[5] - t[4], t[6] - t[5], t[6] - t[0]);
    }
  return 0;
}
"""

SSD_STAMPS = [
    ("  const float a = A[h];\n",
     "+  const int pidx = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) * 4 + (threadIdx.x >> 5);\n  STAMP(0, 0.f);\n"),
    ("    cp_async_wait<0>();\n",
     "    const int ci = static_cast<int>(c0 / Q) * 6 + 1;\n"
     "    STAMP(ci, 0.f);\n"),
    ("    // -- cum and the state-update weights", "    STAMP(ci + 1, 0.f);\n"),
    ("    // -- y: the diagonal block and the carried state",
     "    STAMP(ci + 2, 0.f);\n"),
    ("      const float cum0 = sm.cum[tr0], cum1 = sm.cum[tr1];\n",
     "+      if (c0 == 0 && half == 1) STAMP(16, cf[KN - 1][3]);\n"),
    ("      // The diagonal block: each score tile decayed",
     "      if (c0 == 0 && half == 1) STAMP(14, sc[QT - 1][3] + yo[0][0]);\n"),
    ("      const float e0 = fast_exp2(cum0 * LOG2E);",
     "      if (c0 == 0 && half == 1) STAMP(15, yd[PT - 1][3]);\n"),
    ("    __syncthreads();   // every carried-state read of st is done\n",
     "    STAMP(ci + 3, 0.f);\n"),
    ("    // -- the state update: warp w owns", "    STAMP(ci + 4, 0.f);\n"),
    ("  }\n  __syncthreads();\n  for (int e = tid; e < pvalid * nn;",
     "    STAMP(ci + 5, 0.f);\n"),
    ("  for (int e = tid; e < pvalid * nn; e += THREADS)",
     "  STAMP(13, 0.f);\n"),
]
SSD_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int b = 3, L = 256, H = 24, P = 64, N = 128, Q = 128;
  const size_t nx = size_t(b) * L * H * P, nd = size_t(b) * L * H;
  const size_t nb = size_t(b) * L * N;
  std::vector<float> hx(nx), hd(nd), ha(H), hb(nb);
  for (size_t i = 0; i < nx; ++i) hx[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < nd; ++i) hd[i] = (i * 40503u % 1000) / 2e3f;
  for (int i = 0; i < H; ++i) ha[i] = -0.1f * (i % 5 + 1);
  for (size_t i = 0; i < nb; ++i) hb[i] = (i * 7919u % 1000) / 1e3f - .5f;
  float *x, *dt, *A, *B, *C, *y, *fs;
  cudaMalloc(&x, nx * 4); cudaMalloc(&dt, nd * 4); cudaMalloc(&A, H * 4);
  cudaMalloc(&B, nb * 4); cudaMalloc(&C, nb * 4); cudaMalloc(&y, nx * 4);
  cudaMalloc(&fs, size_t(b) * H * P * N * 4);
  cudaMemcpy(x, hx.data(), nx * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dt, hd.data(), nd * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(A, ha.data(), H * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hb.data(), nb * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(C, hb.data(), nb * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = ssd_scan_launch(x, dt, A, B, C, nullptr, y, fs, b, L, H,
                                   P, 1, N, Q, L * H * P, H * P, L * H, H,
                                   L * N, N, L * N, N, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("ssd phases: launch %d rc %d, %.4f ms\n", rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  for (int blk : {0, 77, 143}) for (int w = 0; w < 4; ++w) {
    const long long* t = hp[blk * 4 + w];
    printf("ssd phases: block %d warp %d cycles:", blk, w);
    long long prev = t[0];
    for (int c = 0; c < 2; ++c) {
      const long long* u = t + 1 + 6 * c;
      printf(" | chunk %d: issue loads %lld, wait %lld, cum %lld, y %lld, "
             "barrier %lld, state update %lld", c, u[0] - prev, u[1] - u[0],
             u[2] - u[1], u[3] - u[2], u[4] - u[3], u[5] - u[4]);
      prev = u[5];
    }
    printf(" | total %lld | chunk 0: first row tile %lld; second: "
           "scores and carried state %lld, diagonal block %lld\n",
           t[13] - t[0], t[16] - t[3], t[14] - t[16], t[15] - t[14]);
  }
  return 0;
}
"""


def instrument(source: str, stamps, extra: str = "") -> str:
    """``source`` with the stamp macro and the stamps inserted; raises
    naming the first line not found."""
    text = (CSRC / source).read_text()
    text = text.replace('#include "mma_tf32x3.cuh"',
                        f'#include "{CSRC / "mma_tf32x3.cuh"}"\n{STAMP}')
    for anchor, insert in stamps:
        if anchor not in text:
            raise RuntimeError(f"{source}: line not found: {anchor!r}")
        if insert is None:
            continue
        if insert.startswith("+"):
            text = text.replace(anchor, anchor + insert[1:], 1)
        else:
            text = text.replace(anchor, insert + anchor, 1)
    return text + extra


def _nvcc() -> str:
    return shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build_and_run(name: str, source: str) -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / f"{name}.cu", OUT / name
    src.write_text(source)
    subprocess.run([_nvcc(), *ARCH, "-std=c++17", "-O3", "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def main() -> None:
    for name, source in (
            ("hmma_rate", HMMA_RATE),
            ("flash_phases", instrument("flash_attention.cu", FLASH_STAMPS,
                                        FLASH_MAIN)),
            ("ssd_phases", instrument("ssd_scan.cu", SSD_STAMPS, SSD_MAIN))):
        print(build_and_run(name, source), end="", flush=True)


if __name__ == "__main__":
    main()
