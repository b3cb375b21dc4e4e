"""Where the tensor-core kernels spend their cycles, on the card.

    PYTHONPATH=src python -m repro_torch.tools.kernel_phases

Builds with nvcc (into ``build/tools/``) and runs plain CUDA programs,
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
   a few blocks, every warp's cycles per phase from the last run. And
   the dk/dv kernel of ``csrc/flash_attention_bwd.cu`` at the trainer's
   shape (q/o/dO (8, 128, 14, 64), causal): every warp's cycles to its
   K/V and first query tile landed, the first tile's S^T and dP^T
   products, its P^T/dS^T epilogue and its dV and dK products, the later
   tiles, the cluster barrier and the reduction over the ranks, for the
   ranks of the first cluster and one rank of the last key tile; and each
   of the backward's kernels timed alone (CUDA events, five launches).
   And the chunk kernel of ``csrc/ssd_scan_bwd.cu`` at the trainer's
   shape (x (8, 128, 24, 64), one chunk of 128): every warp's cycles to
   its dy landed (dt loaded, cp.async issued, the tile list and barrier,
   the cum scan, the wait), M = dP o L, the wait for B, C and C B^T
   (kernel 2a),
   its dx strips, its dC and dB tiles, the barrier after them, and warp
   0's dcum scan, for three blocks; the backward's kernels timed together
   and the group sums (kernel 3) alone.
   Then copies of the backward with its register tiles rewritten (the
   dk/dv pass at 32 or 64 queries, the dq tile at 32 or 64 keys), each
   timed cold and warm at that shape, all three kernels, dk/dv and dq
   alone, and all three with dq launched after dk/dv instead of beside it.
3. **The LSTM-cell tile** (``csrc/lstm_cell_tile.cuh`` through
   ``csrc/fused_gather_lstm_cell.cu``) at the tagger's shape (B = 16,
   E = H = 512): a stamped copy (every warp's cycles, from its CTA's first
   stamp, to the row pointers, the rows stored, the products done (and
   within the chunk loop, the cycles spent waiting on the ring and
   issuing the products), the partial sums, the push into the leader, the
   cluster barrier passed, the epilogue);
   its floors: the same cluster launch with an empty body, and streaming
   only the weights (and the rows) as the tile does; and the unmodified
   kernel timed cold and warm (L2 flushed or not, a spin kernel holding
   the stream, CUDA events, median of 30) at B = 1, 16, 32 with clusters
   of 1, 2 and 4 CTAs (the tool computes the grid for each), and copies of
   the tile with its ``EARLY`` constant (2) rewritten to 0 and 8, in
   clusters of 4.
4. **The row gather**: ``csrc/gather_rows.cu`` at the wrapper's geometry
   and at other block shapes, timed the same way at the path's shapes
   (K = 1, 16, 256, 512 rows of 2048 bytes) beside an empty kernel, and
   checked bit-equal; and its backward's one-launch path
   (``csrc/gather_rows_bwd.cu``) at 1, 2, 4, 8 and 16 rows a block, K = 1
   to 2048 into (2048, 512), checked bit-equal to four rows.

The copies are made from the sources by inserting stamps at fixed lines,
or rewriting them; if a source changes so that a line is not found, the
script says which. Names on the command line (``ssd_bwd_phases``,
``gather_variants``, ...) run only those programs.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

from ..kernels.build import ARCH, CSRC
from ..kernels.fused_cell import cell_geometry
from ..kernels.gather_batch import gather_geometry

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
        q, k, v, o, nullptr, B, S, S, H, KV, D, S * H * D, H * D, D,
        S * KV * D, KV * D, D, S * KV * D, KV * D, D, 1, 0, 0);
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

# the dk/dv kernel of the backward, at the trainer's shape
BWD_STAMPS = [
    ("  const float inv_skv = 1.f / static_cast<float>(a.Skv);\n",
     "+  const int pidx = blockIdx.x * 4 + warp;\n  STAMP(0, 0.f);\n"),
    ("    const int64_t i0 = tiles.at(it % tiles.n);\n",
     "    if (it == 0) STAMP(1, 0.f);\n"),
    ("        // P^T and dS^T on the accumulators",
     "        if (it == 0 && q0 == 0)\n"
     "          STAMP(2, st[NQ - 1][3] + dpt[NQ - 1][3]);\n"),
    ("        // dV += P^T dO and dK += dS^T Q over the pass's queries",
     "        if (it == 0 && q0 == 0)\n"
     "          STAMP(3, st[NQ - 1][3] + dpt[NQ - 1][3]);\n"),
    ("    __syncthreads();   // every warp is done with this Q/dO stage\n",
     "    if (it == 0) STAMP(4, dk[KT - 1][3] + dv[KT - 1][3]);\n"),
    ("  // The cluster's sum: partial dK, dV",
     "  STAMP(5, dk[KT - 1][3] + dv[KT - 1][3]);\n"),
    ("  cluster.sync();   // every rank's partials are written\n",
     "+  STAMP(6, 0.f);\n"),
    ("  cluster.sync();   // no rank leaves while another reads its partials\n",
     "  STAMP(7, 0.f);\n"),
]
BWD_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int B = 8, S = 128, H = 14, KV = 2, D = 64;
  const size_t nq = size_t(B) * S * H * D, nk = size_t(B) * S * KV * D;
  const size_t nl = size_t(B) * H * S;
  std::vector<float> hq(nq), hk(nk), hl(nl, 5.f);
  for (size_t i = 0; i < nq; ++i) hq[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < nk; ++i) hk[i] = (i * 40503u % 1000) / 1e3f - .5f;
  float *q, *k, *v, *o, *dout, *lse, *dvec, *dq, *dk, *dv;
  for (float** p : {&q, &o, &dout, &dq}) cudaMalloc(p, nq * 4);
  for (float** p : {&k, &v, &dk, &dv}) cudaMalloc(p, nk * 4);
  cudaMalloc(&lse, nl * 4); cudaMalloc(&dvec, nl * 4);
  for (float* p : {q, o, dout})
    cudaMemcpy(p, hq.data(), nq * 4, cudaMemcpyHostToDevice);
  for (float* p : {k, v})
    cudaMemcpy(p, hk.data(), nk * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(lse, hl.data(), nl * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  const char* names[] = {"", "rowdot", "dkdv", "", "dq", "", "", "all"};
  for (int parts : {1, 4, 7, 2}) for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = flash_attention_bwd_launch(
        q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, S, H, KV, D,
        S * H * D, H * D, D, S * KV * D, KV * D, D, S * KV * D, KV * D, D,
        S * H * D, H * D, D, S * H * D, H * D, D, 1, 0, parts, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("bwd phases: %s launch %d rc %d, %.4f ms\n", names[parts], rep,
           rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  // cluster 0 (keys 0-63 of batch 0, kv head 0: ranks = query heads 0-6)
  // and rank 0 of cluster 16 (keys 64-127)
  for (int cta : {0, 1, 6, 112}) for (int w = 0; w < 4; ++w) {
    const long long* t = hp[cta * 4 + w];
    const long long first = t[2] ? t[2] - t[1] : 0;
    const long long ep = t[3] ? t[3] - t[2] : 0;
    printf("bwd phases: dkdv CTA %d warp %d cycles: K/V and first Q/dO tile "
           "landed %lld, S^T and dP^T %lld, P^T and dS^T %lld, dV and dK "
           "%lld, later tiles %lld, cluster barrier %lld, reduction %lld, "
           "total %lld\n", cta, w, t[1] - t[0], first, ep,
           t[3] ? t[4] - t[3] : 0, t[5] - t[4], t[6] - t[5], t[7] - t[6],
           t[7] - t[0]);
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
    const int rc = ssd_scan_launch(x, dt, A, B, C, nullptr, y, fs, nullptr,
                                   b, L, H, P, 1, N, Q, L * H * P, H * P,
                                   L * H, H, L * N, N, L * N, N, 0);
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


# The bf16 scan (csrc/ssd_scan_bf16.cu) at the Mamba2 wave's prefill: lane
# 0 of every warp stamps 0 at the start, 1 after the block's set-up, and
# for each of the two chunks (c, from 2 + 7c) the TMA wait passed, the
# barrier on S' passed, the update's A operand built, C B^T and C S'^T
# issued and waited, the update issued, the diagonal block's weights
# formed, every product waited; then 16 + c at the chunk's end (S'
# written, y stored) and 18 after the final state. The producer
# warp stamps 2 + 7c after its arrive for chunk c.
SSD_BF16_STAMPS = [
    ("  const int nc = static_cast<int>(L / Q);\n",
     "+  const int pidx = (blockIdx.y * gridDim.x + blockIdx.x) * (4 * NWG + 1)"
     " + (threadIdx.x >> 5);\n  STAMP(0, 0.f);\n"),
    ("  if (warp == 4 * NWG) {\n", "  STAMP(1, 0.f);\n"),
    ("      hopper::mbar_arrive(&sm.full[s]);\n",
     "+      STAMP(2 + 7 * (c < 2 ? c : 1), 0.f);\n"),
    ("    hopper::mbar_wait(&sm.full[s], (c / NS) & 1);\n",
     "+    const int ci = 2 + 7 * (c < 2 ? c : 1);\n    STAMP(ci, 0.f);\n"),
    ("    hopper::bar_sync(1, 128 * NWG);   // every block of S' is written\n",
     "+    STAMP(ci + 1, 0.f);\n"),
    ("    // -- 2. C B^T of the warpgroup's rows",
     "    STAMP(ci + 2, __uint_as_float(ua[KQ - 1][3]));\n"),
    ("    // -- 3. the update S <- S exp(cum_end)",
     "    STAMP(ci + 3, sc[QT / 2 - 1] + ya[31]);\n"),
    ("    // -- 4. the diagonal block on top", "    STAMP(ci + 4, 0.f);\n"),
    ("      hopper::wg_fence();\n#pragma unroll\n      for (int kk = 0; kk < K; ++kk)\n",
     "      STAMP(ci + 5, __uint_as_float(fa[K - 1][3]));\n"),
    ("    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);\n",
     "    STAMP(ci + 6, ya[31] + st[0][31]);\n"),
    ("              hopper::pack(ya[4 * j + 2], ya[4 * j + 3]);\n      }\n    }\n",
     "+    STAMP(16 + (c < 2 ? c : 1), 0.f);\n"),
    ("            make_float2(st[i][k], st[i][k + 1]);\n    }\n  }\n",
     "+  STAMP(18, 0.f);\n"),
]
SSD_BF16_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int b = 3, L = 256, H = 24, P = 64, N = 128, Q = 128;
  const size_t nx = size_t(b) * L * H * P, nd = size_t(b) * L * H;
  const size_t nb = size_t(b) * L * N;
  std::vector<__nv_bfloat16> hx(nx), hd(nd), hb(nb);
  std::vector<float> ha(H);
  for (size_t i = 0; i < nx; ++i)
    hx[i] = __float2bfloat16((i * 2654435761u % 1000) / 1e3f - .5f);
  for (size_t i = 0; i < nd; ++i)
    hd[i] = __float2bfloat16((i * 40503u % 1000) / 2e3f);
  for (int i = 0; i < H; ++i) ha[i] = -0.1f * (i % 5 + 1);
  for (size_t i = 0; i < nb; ++i)
    hb[i] = __float2bfloat16((i * 7919u % 1000) / 1e3f - .5f);
  __nv_bfloat16 *x, *dt, *B, *C, *y;
  float *A, *fs;
  cudaMalloc(&x, nx * 2); cudaMalloc(&dt, nd * 2); cudaMalloc(&A, H * 4);
  cudaMalloc(&B, nb * 2); cudaMalloc(&C, nb * 2); cudaMalloc(&y, nx * 2);
  cudaMalloc(&fs, size_t(b) * H * P * N * 4);
  cudaMemcpy(x, hx.data(), nx * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dt, hd.data(), nd * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(A, ha.data(), H * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hb.data(), nb * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(C, hb.data(), nb * 2, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = ssd_scan_bf16_launch(
        x, dt, A, B, C, nullptr, y, fs, nullptr, b, L, H, P, 1, N, Q,
        L * H * P, H * P, L * H, H, L * N, N, L * N, N, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("ssd bf16 phases: launch %d rc %d, %.4f ms\n", rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  for (int blk : {0, 35, 71}) for (int w = 0; w < 9; ++w) {
    const long long* t = hp[blk * 9 + w];
    if (w == 8) {
      printf("ssd bf16 phases: block %d producer cycles: set-up %lld, chunk 0 "
             "dt and cum %lld, chunk 1 %lld\n", blk, t[1] - t[0],
             t[2] - t[1], t[9] - t[2]);
      continue;
    }
    printf("ssd bf16 phases: block %d warp %d cycles: set-up %lld", blk, w,
           t[1] - t[0]);
    long long prev = t[1];
    for (int c = 0; c < 2; ++c) {
      const long long* u = t + 2 + 7 * c;
      printf(" | chunk %d: TMA wait %lld, S' barrier %lld, update operand "
             "%lld, C B^T and C S'^T %lld, update issued %lld, diagonal "
             "weights %lld, products waited %lld, S' and y %lld",
             c, u[0] - prev,
             u[1] - u[0], u[2] - u[1], u[3] - u[2], u[4] - u[3],
             u[5] - u[4], u[6] - u[5], t[16 + c] - u[6]);
      prev = t[16 + c];
    }
    printf(" | final state %lld | total %lld\n", t[18] - t[17],
           t[18] - t[0]);
  }
  return 0;
}
"""

# The bf16 attention (csrc/flash_attention_bf16.cu) at the Qwen2 wave's
# larger prefill: 0 at the start, 1 after the block's set-up, 2 with Q
# landed; for the first two K/V tiles (from 3 + 5 it) the TMA wait
# passed, S = Q K^T waited, the softmax done, P V waited; 13 after the
# loop, 14 after the stores.
FLASH_BF16_STAMPS = [
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "+  const int pidx = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) * 5 + warp;\n  STAMP(0, 0.f);\n"),
    ("  if (warp == 4) {\n", "  STAMP(1, 0.f);\n"),
    ("  hopper::mbar_wait(&sm.qbar, 0);\n", "+  STAMP(2, 0.f);\n"),
    ("    hopper::mbar_wait(&sm.full[s], (it / NS) & 1);\n",
     "+    const int ti = 3 + 5 * (it < 2 ? it : 1);\n    STAMP(ti, 0.f);\n"),
    ("    const bool need_mask =", "    STAMP(ti + 1, sf[BK / 2 - 1]);\n"),
    ("    uint32_t pa[BK / 16][4];", "    STAMP(ti + 2, l0 + l1);\n"),
    ("    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);\n",
     "    STAMP(ti + 3, acc[D / 2 - 1]);\n"),
    ("  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);\n",
     "  STAMP(13, acc[D / 2 - 1]);\n"),
    ("          m1 <= MASKED ? MASKED : (m1 + log2f(l1)) * LN2;\n  }\n",
     "+  STAMP(14, 0.f);\n"),
]
FLASH_BF16_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int B = 4, S = 96, H = 14, KV = 2, D = 64;
  const size_t nq = size_t(B) * S * H * D, nk = size_t(B) * S * KV * D;
  std::vector<__nv_bfloat16> hq(nq), hk(nk);
  for (size_t i = 0; i < nq; ++i)
    hq[i] = __float2bfloat16((i * 2654435761u % 1000) / 1e3f - .5f);
  for (size_t i = 0; i < nk; ++i)
    hk[i] = __float2bfloat16((i * 40503u % 1000) / 1e3f - .5f);
  __nv_bfloat16 *q, *k, *v, *o;
  cudaMalloc(&q, nq * 2); cudaMalloc(&k, nk * 2); cudaMalloc(&v, nk * 2);
  cudaMalloc(&o, nq * 2);
  cudaMemcpy(q, hq.data(), nq * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(k, hk.data(), nk * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(v, hk.data(), nk * 2, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = flash_attention_bf16_launch(
        q, k, v, o, nullptr, B, S, S, H, KV, D, S * H * D, H * D, D,
        S * KV * D, KV * D, D, S * KV * D, KV * D, D, 1, 0, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("flash bf16 phases: launch %d rc %d, %.4f ms\n", rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  // grid (11 row tiles, 2 KV heads, 4 batches); tiles 7.. walk two K/V
  // tiles
  for (int cta : {0, 10, 87}) for (int w = 0; w < 4; ++w) {
    const long long* t = hp[cta * 5 + w];
    printf("flash bf16 phases: block %d warp %d cycles: set-up %lld, Q "
           "landed %lld", cta, w, t[1] - t[0], t[2] - t[1]);
    long long prev = t[2];
    for (int it = 0; it < 2; ++it) {
      const long long* u = t + 3 + 5 * it;
      if (u[0] == 0) break;
      printf(" | tile %d: TMA wait %lld, S = Q K^T %lld, softmax %lld, "
             "P V %lld", it, u[0] - prev, u[1] - u[0], u[2] - u[1],
             u[3] - u[2]);
      prev = u[3];
    }
    printf(" | epilogue %lld | total %lld\n", t[14] - t[13], t[14] - t[0]);
  }
  return 0;
}
"""

# Cold and warm timing of one launch, as chip_smoke.py's ColdTimer: the
# L2 flushed (or not) before each (128 MB written, then another 128 MB,
# never written after it was zeroed, read, so that L2 holds no dirty line),
# a spin kernel holding the stream while the host enqueues it, CUDA events
# around it, median of 30.
TIMING = r"""
#include <algorithm>
#include <cstdio>
#include <vector>
__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
}
__global__ void empty_kernel_tool() {}
__global__ void read_kernel(const float4* p, size_t n, float* sink) {
  float acc = 0.f;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    const float4 v = p[i];
    acc += v.x + v.y + v.z + v.w;
  }
  if (acc == 1.f) *sink = acc;   // never: the buffer is zero
}
static char* g_flush = nullptr;
static char* g_clean = nullptr;
static float* g_sink = nullptr;
static const size_t kFlush = size_t(128) << 20;
template <class F>
float time_ms(F launch, bool cold) {
  if (!g_flush) {
    cudaMalloc(&g_flush, kFlush);
    cudaMalloc(&g_clean, kFlush);
    cudaMalloc(&g_sink, sizeof(float));
    cudaMemset(g_clean, 0, kFlush);
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  std::vector<float> t;
  for (int i = 0; i < 33; ++i) {
    if (cold) {
      cudaMemsetAsync(g_flush, i, kFlush);
      read_kernel<<<132 * 8, 256>>>(reinterpret_cast<const float4*>(g_clean),
                                    kFlush / sizeof(float4), g_sink);
    }
    spin_kernel<<<1, 1>>>(1000000);
    cudaEventRecord(e0);
    launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (i >= 3) t.push_back(ms);
  }
  std::sort(t.begin(), t.end());
  return t[t.size() / 2];
}
static void time_floor(const char* tag) {
  auto empty = [] { empty_kernel_tool<<<1, 32>>>(); };
  printf("%s: empty kernel ms cold %.5f, warm %.5f\n", tag,
         time_ms(empty, true), time_ms(empty, false));
}
"""

# Stamps in lstm_cell_tile.cuh (lane 0 of every warp): 0 start, 1 the
# row pointers in (the barrier after them passed), 2 the ring's rows
# stored, 3 the products done (10: cycles waiting on the ring's
# mbarriers, 11: issuing the products, which do not wait for their
# steps), 4 partial sums in shared memory, 5
# pushed into the leader, 6 the cluster barrier passed, 7 the epilogue
# done (leaders only).
CELL_STAMPS = [
    ("  const int lane = tid & 31, warp = tid >> 5;\n",
     "+  const int pidx = (blockIdx.y * gridDim.x + blockIdx.x) * 8 + warp;\n"
     "  STAMP(0, 0.f);\n"),
    ("  __syncthreads();   // the row pointers are in\n",
     "+  STAMP(1, 0.f);\n"),
    ("  const int mt = warp & 1, ks = warp >> 1;\n",
     "  STAMP(2, 0.f);\n  long long t_wait = 0, t_mma = 0;\n"),
    ("    mbar_wait(tf32x3::smem_addr(&full[c % NS]),",
     "    long long tp = clock64();\n"),
    ("              static_cast<uint32_t>((c / NS) & 1));\n",
     "+    t_wait += clock64() - tp;\n    tp = clock64();\n"),
    ("    tf32x3::mma3_row<NT>(a_acc, a, bf);\n",
     "+    t_mma += clock64() - tp;\n"),
    ("  // -- the warps' partial sums: part[ks][col][row] over the ring\n",
     "  STAMP(3, acc[1][NT - 1][3]);\n  if (lane == 0) {\n"
     "    g_prof[pidx][10] = t_wait;\n    g_prof[pidx][11] = t_mma;\n  }\n"),
    ("  cluster_wait();   // every CTA of the cluster is running\n",
     "  STAMP(4, 0.f);\n"),
    ("  cooperative_groups::this_cluster().sync();   // every slot is written\n",
     "  STAMP(5, 0.f);\n"),
    ("  if (rank != 0) return;\n", "  STAMP(6, 0.f);\n"),
    ("    h_out[row * H + col] = o_g * tanh_f(c_new);\n  }\n",
     "+  STAMP(7, 0.f);\n"),
]


def cell_geometry_with_cluster(B: int, K: int, H: int,
                               cluster: int | None = None) -> dict:
    """``cell_geometry(B, K, H)``, or the same with clusters of ``cluster``
    CTAs in place of the wrapper's choice: each CTA reduces
    ``ceil(n_chunks / cluster)`` chunks, and grid x holds ``cluster`` CTAs
    per unit tile."""
    geo = cell_geometry(B, K, H)
    if cluster is None:
        return geo
    return dict(geo, cluster=cluster,
                chunks_per_rank=max(1, -(-geo["n_chunks"] // cluster)),
                grid=(geo["unit_tiles"] * cluster, geo["row_groups"]))


def _cell_args(B: int, cluster: int | None = None) -> str:
    """The geometry arguments of a cell launch at E = H = 512."""
    geo = cell_geometry_with_cluster(B, 1024, 512, cluster)
    return (f"{geo['nt']}, {geo['cluster']}, {geo['chunks_per_rank']}, "
            f"{geo['grid'][0]}, {geo['grid'][1]}")


CELL_SETUP = r"""
#include <cstdint>
struct CellInputs {
  float *x, *h, *c, *w, *b, *ho, *co;
  int32_t *ix, *ih, *ic;
};
static CellInputs cell_inputs(int B, int n, int E, int H) {
  CellInputs in;
  // x, h, c of n rows; w packed as kernels/fused_cell.py:pack_weights
  // packs it (H a multiple of 8 and K of 32 here)
  std::vector<float> hx(size_t(n) * E), hw(size_t(E + H) * 4 * H);
  for (size_t i = 0; i < hx.size(); ++i) hx[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < hw.size(); ++i) hw[i] = (i * 40503u % 1000) / 2e4f - .025f;
  std::vector<int32_t> hi(64);
  for (int i = 0; i < 64; ++i) hi[i] = (i * 7919) % n;
  cudaMalloc(&in.x, hx.size() * 4); cudaMalloc(&in.h, hx.size() * 4);
  cudaMalloc(&in.c, hx.size() * 4); cudaMalloc(&in.w, hw.size() * 4);
  cudaMalloc(&in.b, 4 * H * 4); cudaMalloc(&in.ho, 64 * H * 4);
  cudaMalloc(&in.co, 64 * H * 4);
  cudaMalloc(&in.ix, 64 * 4); cudaMalloc(&in.ih, 64 * 4); cudaMalloc(&in.ic, 64 * 4);
  cudaMemcpy(in.x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(in.h, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(in.c, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice);
  const int K = E + H, C = K / 32;
  std::vector<float> hp(hw.size());
  for (int t = 0; t < H / 8; ++t)
    for (int c = 0; c < C; ++c)
      for (int s = 0; s < 4; ++s)
        for (int mt = 0; mt < 2; ++mt)
          for (int lane = 0; lane < 32; ++lane)
            for (int j = 0; j < 4; ++j) {
              const int k = 32 * c + 8 * s + lane % 4 + 4 * (j / 2);
              const int col = 16 * mt + lane / 4 + 8 * (j % 2);
              hp[((((size_t(t) * C + c) * 4 + s) * 2 + mt) * 32 + lane) * 4 +
                 j] = hw[size_t(k) * 4 * H + (col / 8) * H + t * 8 + col % 8];
            }
  cudaMemcpy(in.w, hp.data(), hp.size() * 4, cudaMemcpyHostToDevice);
  cudaMemset(in.b, 0, 4 * H * 4);
  cudaMemcpy(in.ix, hi.data(), 64 * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(in.ih, hi.data(), 64 * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(in.ic, hi.data(), 64 * 4, cudaMemcpyHostToDevice);
  return in;
}
// CELL_LAUNCH(in, B, nt, cluster, chunks_per_rank, grid_x, grid_y)
#define CELL_LAUNCH(in, B, ...) fused_gather_lstm_cell_launch( \
    in.x, in.h, in.c, in.ix, in.ih, in.ic, in.w, in.b, in.ho, in.co, B, 512, \
    512, 2048, 2048, 2048, __VA_ARGS__, 0)
"""

CELL_MAIN = TIMING + CELL_SETUP + r"""
int main() {
  const int B = 16;
  CellInputs in = cell_inputs(B, 2048, 512, 512);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0); cudaEventCreate(&e1);
    cudaEventRecord(e0);
    const int rc = CELL_LAUNCH(in, B, @GEO@);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("cell phases: launch %d rc %d (%s), %.4f ms\n", rep, rc,
           cudaGetErrorString(cudaGetLastError()), ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  for (int cta : {0, 1, 3, 128}) {
    long long t0 = hp[cta * 8][0];
    for (int w = 1; w < 8; ++w) t0 = std::min(t0, hp[cta * 8 + w][0]);
    for (int w = 0; w < 8; ++w) {
      const long long* t = hp[cta * 8 + w];
      printf("cell phases: CTA %d (rank %d) warp %d, cycles since the CTA's "
             "first stamp: start %lld, row pointers in %lld, rows stored "
             "%lld, products done %lld (waiting on the ring %lld, issuing "
             "the products %lld), partial sums %lld, pushed %lld, cluster "
             "barrier passed %lld, epilogue done %lld\n", cta, cta % 4, w,
             t[0] - t0, t[1] - t0, t[2] - t0, t[3] - t0, t[10], t[11],
             t[4] - t0, t[5] - t0, t[6] - t0, t[7] ? t[7] - t0 : 0LL);
    }
  }
  return 0;
}
"""


# The tile's constant for the chunks of weights issued before the rows;
# the EARLY copies rewrite it.
EARLY_LINE = "constexpr int EARLY = 2;\n"


# The backward's two register-tile constants: queries a dk/dv pass, keys a
# dq tile (both 64 at D = 64).
BWD_QN_LINE = "  static constexpr int QN = D <= 64 ? 64 : 32;"
BWD_BK_LINE = "  static constexpr int BK = D <= 64 ? 64 : 32;"

BWD_VARIANTS_MAIN = TIMING + r"""
int main() {
  const int B = 8, S = 128, H = 14, KV = 2, D = 64;
  const size_t nq = size_t(B) * S * H * D, nk = size_t(B) * S * KV * D;
  const size_t nl = size_t(B) * H * S;
  std::vector<float> hq(nq), hk(nk), hl(nl, 5.f);
  for (size_t i = 0; i < nq; ++i) hq[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < nk; ++i) hk[i] = (i * 40503u % 1000) / 1e3f - .5f;
  float *q, *k, *v, *o, *dout, *lse, *dvec, *dq, *dk, *dv;
  for (float** p : {&q, &o, &dout, &dq}) cudaMalloc(p, nq * 4);
  for (float** p : {&k, &v, &dk, &dv}) cudaMalloc(p, nk * 4);
  cudaMalloc(&lse, nl * 4); cudaMalloc(&dvec, nl * 4);
  for (float* p : {q, o, dout})
    cudaMemcpy(p, hq.data(), nq * 4, cudaMemcpyHostToDevice);
  for (float* p : {k, v})
    cudaMemcpy(p, hk.data(), nk * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(lse, hl.data(), nl * 4, cudaMemcpyHostToDevice);
  time_floor("bwd @TAG@");
  auto launch = [&](int parts) {
    flash_attention_bwd_launch(
        q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, S, H, KV, D,
        S * H * D, H * D, D, S * KV * D, KV * D, D, S * KV * D, KV * D, D,
        S * H * D, H * D, D, S * H * D, H * D, D, 1, 0, parts, 0);
  };
  const char* names[] = {"", "rowdot", "dkdv", "", "dq", "", "", "all"};
  for (int parts : {7, 2, 4}) {
    auto run = [&] { launch(parts); };
    printf("bwd @TAG@: %s ms cold %.5f, warm %.5f\n", names[parts],
           time_ms(run, true), time_ms(run, false));
  }
  // the same kernels with dq launched on its own after dk/dv, not beside it
  auto serial = [&] { launch(3); launch(4); };
  printf("bwd @TAG@: all, dq after dk/dv ms cold %.5f, warm %.5f\n",
         time_ms(serial, true), time_ms(serial, false));
  printf("bwd @TAG@: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def bwd_variant(qn: int, bk: int) -> str:
    """flash_attention_bwd.cu with its dk/dv pass at ``qn`` queries and its
    dq tile at ``bk`` keys (at every D), timed at the trainer's shape."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for line, value in ((BWD_QN_LINE, qn), (BWD_BK_LINE, bk)):
        if text.count(line) != 1:
            raise RuntimeError(f"flash_attention_bwd.cu: line not found "
                               f"once: {line!r}")
        text = text.replace(line, line.split("=")[0] + f"= {value};")
    return text + BWD_VARIANTS_MAIN.replace("@TAG@", f"QN={qn} BK={bk}")


def cell_with_tile(tile: str) -> str:
    """fused_gather_lstm_cell.cu with ``tile`` (a copy of
    lstm_cell_tile.cuh) inlined in place of its include."""
    kernel = (CSRC / "fused_gather_lstm_cell.cu").read_text()
    anchor = '#include "lstm_cell_tile.cuh"'
    if anchor not in kernel:
        raise RuntimeError(f"fused_gather_lstm_cell.cu: line not found: "
                           f"{anchor!r}")
    return kernel.replace(anchor, tile.replace("#pragma once", ""))


def instrument_cell() -> str:
    """A copy of fused_gather_lstm_cell.cu with the stamped tile inlined
    and a host program at B = 16, E = H = 512."""
    return (cell_with_tile(instrument("lstm_cell_tile.cuh", CELL_STAMPS))
            + CELL_MAIN.replace("@GEO@", _cell_args(16)))


def cell_with_early(early: int) -> str:
    """fused_gather_lstm_cell.cu with a copy of the tile whose EARLY is
    ``early``."""
    tile = (CSRC / "lstm_cell_tile.cuh").read_text()
    if tile.count(EARLY_LINE) != 1:
        raise RuntimeError(f"lstm_cell_tile.cuh: line not found once: "
                           f"{EARLY_LINE!r}")
    return cell_with_tile(tile.replace(
        EARLY_LINE, f"constexpr int EARLY = {early};\n"))


CELL_CLUSTERS_MAIN = TIMING + CELL_SETUP + r"""
int main() {
  CellInputs in = cell_inputs(64, 2048, 512, 512);
  time_floor("cell clusters");
@CASES@
  printf("cell clusters: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def cell_clusters_main(only: int | None = None, early: int = 2) -> str:
    """fused_gather_lstm_cell.cu, timed at B = 1, 16, 32 with clusters of
    1, 2 and 4 CTAs (E = H = 512), or with clusters of ``only`` CTAs, on a
    copy of the tile with its EARLY at ``early`` (the source's is 2)."""
    cases = []
    for B in (1, 16, 32):
        for cl in (1, 2, 4) if only is None else (only,):
            geo = _cell_args(B, cl)
            cases.append(
                f"  {{ auto f = [&] {{ CELL_LAUNCH(in, {B}, {geo}); }};\n"
                f"    printf(\"cell clusters: EARLY={early} B=%d cluster=%d ms "
                f"cold %.5f, warm %.5f\\n\", {B}, {cl}, time_ms(f, true), "
                f"time_ms(f, false)); }}")
    kernel = ('#include "fused_gather_lstm_cell.cu"\n' if early == 2
              else cell_with_early(early))
    return kernel + CELL_CLUSTERS_MAIN.replace("@CASES@", "\n".join(cases))


CELL_FLOORS_MAIN = TIMING + CELL_SETUP + r"""
// What a cell launch costs before its arithmetic: the same cluster launch
// (256 CTAs of 256 threads in clusters of 4, the B = 16 tile's dynamic
// shared memory) with an empty body; then streaming each CTA's K slice of
// the packed weights (eight 4 KB bulk copies on one mbarrier) and nothing
// else; then that and the CTA's rows (16 rows x 256 k, float4 loads
// stored into shared memory).
__global__ void __launch_bounds__(256) empty_cluster_kernel() {}
__global__ void __launch_bounds__(256) stream_kernel(const float* wp,
                                                     const float* x,
                                                     int with_rows) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long bar;
  const uint32_t b = tf32x3::smem_addr(&bar);
  const int tile = blockIdx.x / 4, rank = blockIdx.x % 4;
  if (threadIdx.x == 0) {
    lstm_tile::mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 32) {
    lstm_tile::mbar_expect(b, 8 * lstm_tile::CHUNK_BYTES);
    for (int c = 0; c < 8; ++c)
      lstm_tile::bulk_copy(smem + c * 1024,
                           wp + (size_t(tile) * 32 + rank * 8 + c) * 1024,
                           lstm_tile::CHUNK_BYTES, b);
  }
  if (with_rows) {
    float* rs = smem + 8 * 1024;
    for (int i = 0; i < 4; ++i) {
      const int p = threadIdx.x + i * 256;   // 16 rows x 64 float4
      const int m = p / 64, q = p % 64;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          x + size_t((m * 7919) % 2048) * 512 + rank * 256 % 512 + q * 4));
      *reinterpret_cast<float4*>(rs + m * 260 + q * 4) = v;
    }
  }
  lstm_tile::mbar_wait(b, 0);
}
int main() {
  CellInputs in = cell_inputs(16, 2048, 512, 512);
  time_floor("cell floors");
  const size_t smem = lstm_tile::Tile<2>::smem_bytes(4);
  cudaFuncSetAttribute(empty_cluster_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  cudaFuncSetAttribute(stream_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(256);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 4;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto empty = [&] { cudaLaunchKernelEx(&cfg, empty_cluster_kernel); };
  auto stream = [&] {
    cudaLaunchKernelEx(&cfg, stream_kernel, (const float*)in.w,
                       (const float*)in.x, 0);
  };
  auto rows = [&] {
    cudaLaunchKernelEx(&cfg, stream_kernel, (const float*)in.w,
                       (const float*)in.x, 1);
  };
  auto cell = [&] { CELL_LAUNCH(in, 16, @GEO@); };
  printf("cell floors: empty cluster launch ms cold %.5f, warm %.5f\n",
         time_ms(empty, true), time_ms(empty, false));
  printf("cell floors: weights streamed ms cold %.5f, warm %.5f\n",
         time_ms(stream, true), time_ms(stream, false));
  printf("cell floors: weights and rows streamed ms cold %.5f, warm %.5f\n",
         time_ms(rows, true), time_ms(rows, false));
  printf("cell floors: the cell (B = 16) ms cold %.5f, warm %.5f\n",
         time_ms(cell, true), time_ms(cell, false));
  printf("cell floors: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def cell_floors_main() -> str:
    """Floors of the cell launch at B = 16, E = H = 512 (see the program's
    comment), beside the cell itself."""
    return ('#include "fused_gather_lstm_cell.cu"\n'
            + CELL_FLOORS_MAIN.replace("@GEO@", _cell_args(16)))


GATHER_MAIN = TIMING + r"""
// a block shape of the kernel: (tc, r, v, row tiles, unit tiles, grid)
struct Variant {
  long long k, tc, r, v, row_tiles, tiles, gx, gy, unit;
};
int main() {
  const Variant variants[] = {
@VARIANTS@
  };
  const int n = 2048, row_bytes = 2048;
  char *src, *out, *want;
  int32_t* idx;
  cudaMalloc(&src, size_t(n) * row_bytes);
  cudaMalloc(&out, size_t(1024) * row_bytes);
  cudaMalloc(&want, size_t(1024) * row_bytes);
  cudaMalloc(&idx, 1024 * 4);
  std::vector<char> hs(size_t(n) * row_bytes);
  for (size_t i = 0; i < hs.size(); ++i) hs[i] = char(i * 2654435761u >> 13);
  std::vector<int32_t> hi(1024);
  for (int i = 0; i < 1024; ++i) hi[i] = (i * 7919) % n - (i % 3 ? 0 : n);
  cudaMemcpy(src, hs.data(), hs.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(idx, hi.data(), 1024 * 4, cudaMemcpyHostToDevice);
  time_floor("gather variants");
  for (const Variant& x : variants) {
    auto run = [&](char* dst) {
      gather_rows_launch(src, idx, dst, n, x.k, row_bytes, x.unit, x.tc,
                         x.r, x.v, x.row_tiles, x.tiles, x.gx, x.gy, 0);
    };
    // the reference: one 16-byte unit a thread, a row a block
    gather_rows_launch(src, idx, want, n, x.k, row_bytes, 16, 128, 1, 1,
                       x.k, 1, x.k, 1, 0);
    run(out);
    cudaDeviceSynchronize();
    std::vector<char> a(size_t(x.k) * row_bytes), b(a.size());
    cudaMemcpy(a.data(), out, a.size(), cudaMemcpyDeviceToHost);
    cudaMemcpy(b.data(), want, b.size(), cudaMemcpyDeviceToHost);
    auto f = [&] { run(out); };
    printf("gather variants: K=%lld %lld-byte units, tc=%lld r=%lld v=%lld "
           "unit tiles %lld: ms cold %.5f, warm %.5f; bit-equal %s\n", x.k,
           x.unit, x.tc, x.r, x.v, x.tiles, time_ms(f, true),
           time_ms(f, false), a == b ? "yes" : "NO");
  }
  printf("gather variants: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


# the row gather's backward, one-launch path, by rows a block
GATHER_BWD_MAIN = TIMING + r"""
int main() {
  const int n = 2048, row_bytes = 2048, D = row_bytes / 4;
  float *dout, *dsrc, *want;
  int32_t* idx;
  cudaMalloc(&dout, size_t(2048) * row_bytes);
  cudaMalloc(&dsrc, size_t(n) * row_bytes);
  cudaMalloc(&want, size_t(n) * row_bytes);
  cudaMalloc(&idx, 2048 * 4);
  std::vector<float> hd(size_t(2048) * D);
  for (size_t i = 0; i < hd.size(); ++i)
    hd[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  std::vector<int32_t> hi(2048);
  for (int i = 0; i < 2048; ++i) hi[i] = (i * 7919) % n - (i % 3 ? 0 : n);
  cudaMemcpy(dout, hd.data(), hd.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(idx, hi.data(), 2048 * 4, cudaMemcpyHostToDevice);
  time_floor("gather bwd variants");
  for (long long k : {1, 16, 256, 512, 2048}) {
    // the reference: four rows a block, the wrapper's choice at these K
    gather_rows_bwd_launch(dout, idx, want, nullptr, nullptr, n, k,
                           row_bytes, 16, 4, 0, 0, 0, 0, 0, 0, 0, 0);
    for (long long rows : {1, 2, 4, 8, 16}) {
      auto f = [&] {
        gather_rows_bwd_launch(dout, idx, dsrc, nullptr, nullptr, n, k,
                               row_bytes, 16, rows, 0, 0, 0, 0, 0, 0, 0, 0);
      };
      f();
      cudaDeviceSynchronize();
      std::vector<float> a(size_t(n) * D), b(a.size());
      cudaMemcpy(a.data(), dsrc, a.size() * 4, cudaMemcpyDeviceToHost);
      cudaMemcpy(b.data(), want, b.size() * 4, cudaMemcpyDeviceToHost);
      printf("gather bwd variants: K=%lld into (%d, %d), %lld rows a "
             "block: ms cold %.5f, warm %.5f; bit-equal to four rows %s\n",
             k, n, D, rows, time_ms(f, true), time_ms(f, false),
             a == b ? "yes" : "NO");
    }
  }
  printf("gather bwd variants: %s\n",
         cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


# the scan's backward chunk kernel, at the trainer's shape
SSD_BWD_STAMPS = [
    ("  const float* ssrc = has_s ? a.states + slot : nullptr;\n",
     "+  const int pidx = (blockIdx.y * gridDim.x + blockIdx.x) * WARPS + warp;"
     "\n  STAMP(0, 0.f);\n"),
    ("  stage_async<MAXP>(sm.ys, LDP, Q16, yb, a.H * a.P, q, pp, a.vec_y);\n",
     "  STAMP(8, dtv);\n"),
    ("  if (tid == 0) {\n    // dC tiles (8 t wide", "  STAMP(9, 0.f);\n"),
    ("  if (warp == 0) {\n    // cum (inclusive scan", "  STAMP(10, 0.f);\n"),
    ("  cp_async_wait<1>();   // dy\n", "  STAMP(11, 0.f);\n"),
    ("  // -- a. M = (dy x^T) o L, s-major, by strips", "  STAMP(1, 0.f);\n"),
    ("  cp_async_wait<0>();   // B and C\n", "  STAMP(7, 0.f);\n"),
    ("  __syncthreads();   // M is whole\n", "+  STAMP(2, 0.f);\n"),
    ("  // -- b. the dC and dB tiles, drawn longest first",
     "  STAMP(3, 0.f);\n"),
    ("  __syncthreads();\n\n  // -- c. <S0, G>", "  STAMP(4, 0.f);\n"),
    ("  float sg = 0.f;\n  if (has_g && has_s) {", "  STAMP(5, 0.f);\n"),
    ("    if (lane == 0) a.dapart[bc * a.H + h] = da;\n",
     "+    STAMP(6, da);\n"),
]
SSD_BWD_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int b = 8, L = 128, H = 24, P = 64, N = 128, Q = 128;
  const size_t nx = size_t(b) * L * H * P, nd = size_t(b) * L * H;
  const size_t nb = size_t(b) * L * N, nh = size_t(b) * L * H * N;
  std::vector<float> hx(nx), hd(nd), ha(H), hb(nb);
  for (size_t i = 0; i < nx; ++i) hx[i] = (i * 2654435761u % 1000) / 1e3f - .5f;
  for (size_t i = 0; i < nd; ++i) hd[i] = (i * 40503u % 1000) / 2e3f;
  for (int i = 0; i < H; ++i) ha[i] = -0.1f * (i % 5 + 1);
  for (size_t i = 0; i < nb; ++i) hb[i] = (i * 7919u % 1000) / 1e3f - .5f;
  float *x, *dt, *A, *B, *C, *dy, *dbh, *dch, *dap, *dx, *ddt, *dA, *dB, *dC;
  float* cbuf;   // (b, S16 = 8, 16 tiles, 32 lanes, 4)
  cudaMalloc(&cbuf, size_t(b) * 8 * 16 * 32 * 4 * 4);
  for (float** q : {&x, &dy, &dx}) cudaMalloc(q, nx * 4);
  for (float** q : {&dt, &ddt}) cudaMalloc(q, nd * 4);
  for (float** q : {&B, &C, &dB, &dC}) cudaMalloc(q, nb * 4);
  for (float** q : {&dbh, &dch}) cudaMalloc(q, nh * 4);
  cudaMalloc(&A, H * 4); cudaMalloc(&dA, H * 4); cudaMalloc(&dap, b * H * 4);
  for (float* q : {x, dy}) cudaMemcpy(q, hx.data(), nx * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dt, hd.data(), nd * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(A, ha.data(), H * 4, cudaMemcpyHostToDevice);
  for (float* q : {B, C}) cudaMemcpy(q, hb.data(), nb * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = ssd_scan_bwd_launch(
        x, dt, A, B, C, dy, nullptr, nullptr, nullptr, cbuf, dbh, dch, dap, dx,
        ddt, dA, dB, dC, nullptr, b, L, H, P, 1, N, Q, 0, L * H * P, H * P,
        L * H, H, L * N, N, L * N, N, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("ssd bwd phases: all four kernels, launch %d rc %d, %.4f ms\n",
           rep, rc, ms);
  }
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    ssd_bwd_sum_kernel<float4><<<(b * L * N / 4 + 255) / 256, 256>>>(
        reinterpret_cast<const float4*>(dbh),
        reinterpret_cast<const float4*>(dch), dap,
        reinterpret_cast<float4*>(dB), reinterpret_cast<float4*>(dC), dA,
        b * L, H, 1, N / 4, b);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("ssd bwd phases: the group sums alone (kernel 3, %.1f MB of "
           "per-head scratch read), launch %d, %.4f ms\n",
           2.0 * nh * 4 / 1e6, rep, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  for (int blk : {0, 100, 191}) for (int w = 0; w < 16; ++w) {
    const long long* t = hp[blk * 16 + w];
    printf("ssd bwd phases: block %d warp %d start cycles: dt loaded "
           "%lld, cp.async issued %lld, tile list and barrier %lld, cum "
           "%lld, dy's wait and barrier %lld\n", blk, w, t[8] - t[0],
           t[9] - t[8], t[10] - t[9], t[11] - t[10], t[1] - t[11]);
    printf("ssd bwd phases: block %d warp %d cycles: dy landed %lld, "
           "M = dP o L %lld, B, C and kernel 2a waited for %lld, dx strips "
           "(K o dt, dx) %lld, dC and dB tiles %lld, barrier %lld, dcum scan "
           "%lld, total %lld\n", blk, w, t[1] - t[0], t[7] - t[1],
           t[2] - t[7], t[3] - t[2], t[4] - t[3], t[5] - t[4],
           t[6] ? t[6] - t[5] : 0, (t[6] ? t[6] : t[5]) - t[0]);
  }
  return 0;
}
"""


# the bf16 backward of attention (csrc/flash_attention_bwd_bf16.cu) at the
# trainer's shape: dk/dv's set-up, K/V landed, per query tile the TMA wait,
# S^T and dP^T (wgmma issue and wait), the P^T/dS^T epilogue, dV and dK
# (wgmma), then the cluster's partials and ordered sum; dq's Q/dO landed and
# per key tile the wait, S and dP, the dS epilogue and dQ
FLASH_BWD_BF16_STAMPS = [
    ('  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "+  const int pidx = blockIdx.x * 5 + warp;\n  STAMP(0, 0.f);\n"),
    ("  const int g = lane >> 2, t = lane & 3;\n"
     "  const int r0 = 16 * warp + g, r1 = r0 + 8;   // the lane's two keys\n",
     "  STAMP(1, 0.f);\n"),
    ("    hopper::mbar_wait(&sm.kvbar, 0);\n", "+    STAMP(2, 0.f);\n"),
    ("      float st[BM / 2], dpt[BM / 2];   // S^T, dP^T: keys x rows\n",
     "+      const int ti = 3 + 4 * (it < 2 ? it : 1);\n"
     "      STAMP(ti, 0.f);\n"),
    ("      // P^T and dS^T: d[4j + e] is key r0",
     "      STAMP(ti + 1, st[BM / 2 - 1] + dpt[BM / 2 - 1]);\n"),
    ("      uint32_t pa[BM / 16][4], sa[BM / 16][4];\n",
     "      STAMP(ti + 2, st[BM / 2 - 1] + dpt[BM / 2 - 1]);\n"),
    ("      hopper::fence_regs(dk);\n      hopper::fence_regs(dv);\n",
     "+      STAMP(ti + 3, dk[D / 2 - 1] + dv[D / 2 - 1]);\n"),
    ("  const int64_t kvrow = static_cast<int64_t>(b) * a.Skv;\n",
     "  STAMP(11, 0.f);\n"),
    ("  cluster.sync();   // every rank's partials are written\n",
     "+  STAMP(12, 0.f);\n"),
    ("  cluster.sync();   // no rank leaves while another reads its partials\n",
     "  STAMP(13, 0.f);\n"),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  // the last query tiles see the most keys: they go first\n",
     "+  const int pidx = 2048 + ((blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x) * 5 + warp;\n  STAMP(0, 0.f);\n"),
    ("    hopper::mbar_wait(&sm.qbar, 0);\n", "+    STAMP(1, 0.f);\n"),
    ("      float sf[BM / 2], dp[BM / 2];   // S, dP: column tile j at",
     "      const int ti = 2 + 4 * (it < 2 ? it : 1);\n"
     "      STAMP(ti, 0.f);\n"),
    ("      const bool need_mask =\n          j0 + BM > a.Skv ||",
     "      STAMP(ti + 1, sf[BM / 2 - 1] + dp[BM / 2 - 1]);\n"),
    ("      uint32_t sa[BM / 16][4];\n",
     "      STAMP(ti + 2, dp[BM / 2 - 1]);\n"),
    ("      hopper::fence_regs(acc);\n",
     "+      STAMP(ti + 3, acc[D / 2 - 1]);\n"),
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n',
     "  STAMP(10, 0.f);\n"),
]
FLASH_BWD_BF16_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int B = 8, S = 128, H = 14, KV = 2, D = 64, QB = 64 / (H / KV);
  const int NQT = (S + QB - 1) / QB;
  const size_t nq = size_t(B) * S * H * D, nk = size_t(B) * S * KV * D;
  const size_t nl = size_t(B) * H * S, nt = size_t(B) * KV * NQT * 128;
  std::vector<__nv_bfloat16> hq(nq), hk(nk);
  std::vector<float> hl(nl, 5.f);
  for (size_t i = 0; i < nq; ++i)
    hq[i] = __float2bfloat16((i * 2654435761u % 1000) / 1e3f - .5f);
  for (size_t i = 0; i < nk; ++i)
    hk[i] = __float2bfloat16((i * 40503u % 1000) / 1e3f - .5f);
  __nv_bfloat16 *q, *k, *v, *o, *dout, *dq, *dk, *dv;
  float *lse, *tab;
  for (__nv_bfloat16** p : {&q, &o, &dout, &dq}) cudaMalloc(p, nq * 2);
  for (__nv_bfloat16** p : {&k, &v, &dk, &dv}) cudaMalloc(p, nk * 2);
  cudaMalloc(&lse, nl * 4); cudaMalloc(&tab, nt * 4);
  for (__nv_bfloat16* p : {q, o, dout})
    cudaMemcpy(p, hq.data(), nq * 2, cudaMemcpyHostToDevice);
  for (__nv_bfloat16* p : {k, v})
    cudaMemcpy(p, hk.data(), nk * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(lse, hl.data(), nl * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  const char* names[] = {"", "rows", "dkdv", "", "dq", "", "", "all"};
  for (int parts : {1, 4, 2, 7}) for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = flash_attention_bwd_bf16_launch(
        q, k, v, o, dout, lse, tab, dq, dk, dv, B, S, S, H, KV, D,
        S * H * D, H * D, D, S * KV * D, KV * D, D, S * KV * D, KV * D, D,
        S * H * D, H * D, D, S * H * D, H * D, D, 1, 0, parts, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("bwd bf16 phases: %s launch %d rc %d, %.4f ms\n", names[parts],
           rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  // dk/dv: 256 CTAs, clusters of 8 ranks over (key tile, batch, kv head);
  // CTAs 0..7 the first cluster (keys 0-63: 15 query tiles, one or two a
  // rank), 128 the first rank of keys 64-127 (8 tiles, one a rank)
  for (int cta : {0, 3, 128, 255}) for (int w = 0; w < 4; ++w) {
    const long long* t = hp[cta * 5 + w];
    printf("bwd bf16 phases: dkdv CTA %d warp %d cycles: set-up %lld, K/V "
           "landed %lld", cta, w, t[1] - t[0], t[2] - t[1]);
    long long prev = t[2];
    for (int it = 0; it < 2; ++it) {
      const long long* u = t + 3 + 4 * it;
      if (u[0] == 0) break;
      printf(" | tile %d: TMA wait %lld, S^T and dP^T %lld, P^T/dS^T %lld, "
             "dV and dK %lld", it, u[0] - prev, u[1] - u[0], u[2] - u[1],
             u[3] - u[2]);
      prev = u[3];
    }
    printf(" | rest of the tiles %lld | partials and cluster barrier %lld "
           "| ordered sum %lld | total %lld\n", t[11] - prev, t[12] - t[11],
           t[13] - t[12], t[13] - t[0]);
  }
  // dq: 15 x 2 x 8 CTAs, the last query tile (two key tiles) first
  for (int cta : {0, 14}) for (int w = 0; w < 4; ++w) {
    const long long* t = hp[2048 + cta * 5 + w];
    printf("bwd bf16 phases: dq CTA %d warp %d cycles: Q and dO landed %lld",
           cta, w, t[1] - t[0]);
    long long prev = t[1];
    for (int it = 0; it < 2; ++it) {
      const long long* u = t + 2 + 4 * it;
      if (u[0] == 0) break;
      printf(" | tile %d: TMA wait %lld, S and dP %lld, dS %lld, dQ %lld",
             it, u[0] - prev, u[1] - u[0], u[2] - u[1], u[3] - u[2]);
      prev = u[3];
    }
    printf(" | epilogue %lld | total %lld\n", t[10] - prev, t[10] - t[0]);
  }
  return 0;
}
"""

# the bf16 backward of the scan's chunk kernel (csrc/ssd_scan_bwd_bf16.cu)
# at the trainer's shape: set-up, C and B landed, per head (the first and
# the last of the block) the x/dy wait, the t pass (C B^T and dy x^T by
# wgmma, the K/M epilogue and tiles, dC), its barrier, dx, dB, the barrier
# before the dcum scan (the scan itself falls in the next head's wait);
# then the group's partials, the cluster's ordered sum and dA
SSD_BWD_BF16_STAMPS = [
    ("  const int grp = static_cast<int>(blockIdx.x / a.cluster);\n",
     "+  const int pidx = (blockIdx.y * gridDim.x + blockIdx.x) * 8 + "
     "(threadIdx.x >> 5);\n  STAMP(0, 0.f);\n"),
    ("  const int g = lane >> 2, tq = lane & 3;\n  const int64_t orow",
     "  STAMP(1, 0.f);\n"),
    ("      hopper::mbar_wait(&sm.cbbar, 0);\n", "+      STAMP(2, 0.f);\n"),
    ("        hopper::mbar_wait(&sm.full[s], (i / NS) & 1);\n",
     "+        const int hi = 3 + 6 * (i < 1 ? 0 : 1);\n"
     "        STAMP(hi, 0.f);\n"),
    ("          // the S0 term: dC += e_t",
     "          STAMP(hi + 1, dcg[63]);\n"),
    ("        hopper::fence_async_smem();   // the K and M tiles, for wgmma\n"
     "        hopper::bar_sync(1, THREADS);\n",
     "+        STAMP(hi + 2, 0.f);\n"),
    ("          float xgb[2] = {0.f, 0.f};\n",
     "          STAMP(hi + 3, dx[31]);\n"),
    ("        hopper::bar_sync(1, THREADS);   // t2 and the column sums are in\n",
     "        STAMP(hi + 4, dbg[63]);\n"),
    ("        // -- c. dcum, its suffix sum, ddt", "        STAMP(hi + 5, 0.f);\n"),
    ("  if (a.cluster > 1) {\n", "  STAMP(15, 0.f);\n"),
    ("    cluster.sync();   // every rank's partials are written\n",
     "+    STAMP(16, 0.f);\n"),
    ("    cluster.sync();   // no rank leaves while another reads its partials\n",
     "    STAMP(17, 0.f);\n"),
    ("  // ---- dA: the last block adds", "  STAMP(18, 0.f);\n"),
]
SSD_BWD_BF16_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
  const int b = 8, L = 128, H = 24, P = 64, N = 128, Q = 128;
  const size_t nx = size_t(b) * L * H * P, nd = size_t(b) * L * H;
  const size_t nb = size_t(b) * L * N;
  std::vector<__nv_bfloat16> hx(nx), hd(nd), hb(nb);
  std::vector<float> ha(H);
  for (size_t i = 0; i < nx; ++i)
    hx[i] = __float2bfloat16((i * 2654435761u % 1000) / 1e3f - .5f);
  for (size_t i = 0; i < nd; ++i)
    hd[i] = __float2bfloat16((i * 40503u % 1000) / 2e3f);
  for (int i = 0; i < H; ++i) ha[i] = -0.1f * (i % 5 + 1);
  for (size_t i = 0; i < nb; ++i)
    hb[i] = __float2bfloat16((i * 7919u % 1000) / 1e3f - .5f);
  __nv_bfloat16 *x, *dt, *B, *C, *dy, *dx, *ddt, *dB, *dC;
  float *A, *dA, *dap;
  unsigned int* counter;
  for (__nv_bfloat16** p : {&x, &dy, &dx}) cudaMalloc(p, nx * 2);
  for (__nv_bfloat16** p : {&dt, &ddt}) cudaMalloc(p, nd * 2);
  for (__nv_bfloat16** p : {&B, &C, &dB, &dC}) cudaMalloc(p, nb * 2);
  cudaMalloc(&A, H * 4); cudaMalloc(&dA, H * 4); cudaMalloc(&dap, b * H * 4);
  cudaMalloc(&counter, 4); cudaMemset(counter, 0, 4);
  for (__nv_bfloat16* p : {x, dy})
    cudaMemcpy(p, hx.data(), nx * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dt, hd.data(), nd * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(A, ha.data(), H * 4, cudaMemcpyHostToDevice);
  for (__nv_bfloat16* p : {B, C})
    cudaMemcpy(p, hb.data(), nb * 2, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    const int rc = ssd_scan_bwd_bf16_launch(
        x, dt, A, B, C, dy, nullptr, nullptr, nullptr, nullptr, dap,
        counter, dx, ddt, dA, dB, dC, nullptr, b, L, H, P, 1, N, Q, 0,
        L * H * P, H * P, L * H, H, L * N, N, L * N, N, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("ssd bwd bf16 phases: launch %d rc %d, %.4f ms\n", rep, rc, ms);
  }
  static long long hp[4096][20];
  cudaMemcpyFromSymbol(hp, g_prof, sizeof(hp));
  // 64 blocks: 8 head blocks of 3 heads (one cluster) by 8 (batch, chunk)
  for (int blk : {0, 7, 63}) for (int w : {0, 3, 4, 7}) {
    const long long* t = hp[blk * 8 + w];
    printf("ssd bwd bf16 phases: block %d warp %d cycles: set-up %lld, C "
           "and B landed %lld", blk, w, t[1] - t[0], t[2] - t[1]);
    long long prev = t[2];
    for (int i = 0; i < 2; ++i) {
      const long long* u = t + 3 + 6 * i;
      printf(" | %s head: x/dy wait %lld, t pass (C B^T, dy x^T, K/M, dC) "
             "%lld, barrier %lld, dx %lld, dB %lld, barrier %lld",
             i ? "last" : "first", u[0] - prev, u[1] - u[0], u[2] - u[1],
             u[3] - u[2], u[4] - u[3], u[5] - u[4]);
      prev = u[5];
    }
    printf(" | partials %lld, cluster barrier %lld, ordered sum %lld, "
           "dA's count %lld | total %lld\n", t[15] - prev, t[16] - t[15],
           t[17] - t[16], t[18] - t[17], t[18] - t[0]);
  }
  return 0;
}
"""


def gather_main() -> str:
    """gather_rows.cu at the path's shapes (K = 1, 16, 256, 512 rows of
    2048 bytes): with the geometry the wrapper computes, and with other
    block shapes (four 16-byte units a thread, 32 threads a row and two
    rows a block; half a row a block; and 4-byte units, one or four a
    thread, in 128-thread blocks)."""
    variants = []
    for k in (1, 16, 256, 512):
        vec = gather_geometry(k, 2048, 16)
        for unit, tc, r, v in ((16, vec["tc"], vec["r"], vec["v"]),
                               (16, 32, 2, 4), (16, 32, 1, 2),
                               (4, 128, 1, 1), (4, 128, 1, 4)):
            r = min(r, k)
            tiles, rows = -(-(2048 // unit) // (tc * v)), -(-k // r)
            variants.append(f"    {{{k}, {tc}, {r}, {v}, {rows}, {tiles}, "
                            f"{rows}, {tiles}, {unit}}},")
    return ('#include "gather_rows.cu"\n'
            + GATHER_MAIN.replace("@VARIANTS@", "\n".join(variants)))


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
    built = subprocess.run([_nvcc(), *ARCH, "-std=c++17", "-O3", "-I",
                            str(CSRC), "-o", str(exe), str(src)],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{built.stdout}"
                           f"{built.stderr}")
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def main(argv: list[str] | None = None) -> None:
    """Builds and runs every program, or those named in ``argv``."""
    import sys

    only = set(sys.argv[1:] if argv is None else argv)
    for name, source in (
            ("hmma_rate", HMMA_RATE),
            ("flash_phases", instrument("flash_attention.cu", FLASH_STAMPS,
                                        FLASH_MAIN)),
            ("bwd_phases", instrument("flash_attention_bwd.cu", BWD_STAMPS,
                                      BWD_MAIN)),
            ("ssd_phases", instrument("ssd_scan.cu", SSD_STAMPS, SSD_MAIN)),
            ("flash_bf16_phases", instrument("flash_attention_bf16.cu",
                                             FLASH_BF16_STAMPS,
                                             FLASH_BF16_MAIN)),
            ("ssd_bf16_phases", instrument("ssd_scan_bf16.cu",
                                           SSD_BF16_STAMPS, SSD_BF16_MAIN)),
            ("ssd_bwd_phases", instrument("ssd_scan_bwd.cu", SSD_BWD_STAMPS,
                                          SSD_BWD_MAIN)),
            ("flash_bwd_bf16_phases", instrument(
                "flash_attention_bwd_bf16.cu", FLASH_BWD_BF16_STAMPS,
                FLASH_BWD_BF16_MAIN)),
            ("ssd_bwd_bf16_phases", instrument(
                "ssd_scan_bwd_bf16.cu", SSD_BWD_BF16_STAMPS,
                SSD_BWD_BF16_MAIN)),
            ("cell_phases", instrument_cell()),
            ("cell_clusters", cell_clusters_main()),
            ("cell_floors", cell_floors_main()),
            ("gather_variants", gather_main()),
            ("gather_bwd_variants",
             '#include "gather_rows_bwd.cu"\n' + GATHER_BWD_MAIN),
            ("cell_early_0", cell_clusters_main(4, 0)),
            ("cell_early_8", cell_clusters_main(4, 8)),
            *((f"bwd_qn{qn}_bk{bk}", bwd_variant(qn, bk))
              for qn, bk in ((64, 64), (32, 64), (64, 32), (32, 32)))):
        if not only or name in only:
            print(build_and_run(name, source), end="", flush=True)


if __name__ == "__main__":
    main()
