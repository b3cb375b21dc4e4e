// Chunked SSD scan (Mamba-2), fp32. Per head, with the state S (p, n)
// starting at the given initial state (or zero) and cum the within-chunk
// cumulative sum of dt * A:
//   y[t]   = sum_{s <= t in chunk} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//            + exp(cum_t) S C_t
//   S     <- S exp(cum_end) + sum_s x_s dt_s exp(cum_end - cum_s) B_s^T
// chunk after chunk; the final S is written out for the decode cache, and,
// when asked (for the backward, csrc/ssd_scan_bwd.cu), the S each chunk
// starts from. Those writes read the state and change nothing else, so y
// and the final S are the same bit for bit with and without them.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// (grid (batch, head blocks, chunks) with the chunk axis sequential and
// the (heads, p, n) state in VMEM scratch; B and C expanded to heads by
// the caller; the final state not written).
//
// Bound on the H100: operations. At the path's shapes (Mamba2-130m
// prefill: 24 heads, p = 64, n = 128, one group) the fewest FLOPs come
// from the chunked algorithm at a chunk of 7 steps (per step 4np for the
// carried state and the update, (q + 1)(n + p) for the scores and the
// diagonal block, np / q for the state's decay), 0.87 of the sequential
// recurrence's 5 per step and state entry: 0.654 GFLOP at l = 256,
// b = 3, or 4.0 us at the 165 TFLOP/s of 3xTF32 on the tensor cores,
// against 3.8 us for its bytes (chip_smoke.py:ssd_flops).
//
// Design: one block per (batch, head, 32 rows of p), four warps. Each
// state row evolves on its own, so a block carries a 32 x n slice of the
// state through a loop over the chunks (the loop takes the place of the
// TPU grid's sequential chunk axis), and two blocks cover a head of 64:
// 144 blocks at the timed shape, at most two on an SM (102 KB of shared
// memory each), one round on 132 SMs. All four products of a chunk run
// on the tensor cores as 3xTF32 m16n8k8 steps (mma_tf32x3.cuh), at the
// fp32 plain version's accuracy. A warp takes two 16-row tiles of the
// chunk (w and 7 - w, so the triangle's work is even) and holds their C
// rows in registers (read straight from global memory); for each:
//   1. the scores C B^T, for the column tiles on or below the diagonal
//      (in groups of four), and 3. the carried state C S^T (scaled by
//      exp(cum_t)),
//      in one pass over n that splits each C fragment once for both;
//   2. the diagonal block (scores o decay o dt) (x): each score tile is
//      scaled in registers by exp(cum_t - cum_s) dt_s, formed only where
//      s <= t (above the diagonal the exponent is positive and can
//      overflow), and fed straight back as the A operand (the paired k
//      order of the header).
//   4. The update S <- S exp(cum_end) + (x)^T (B o dt o exp(cum_end -
//      cum_s)): each warp owns a quarter of the state's columns, seeds its
//      accumulators from shared memory and writes them back.
// Tiles that share an operand are issued term by term (`mma3_row`), so
// consecutive tensor-core steps do not wait on each other: a warp issues
// in order.
// B and x of a chunk (and dt) are staged in shared memory by cp.async,
// 16 bytes a thread where rows are 16-byte aligned, 4 bytes where they are
// not, with zero fill past the chunk, p and n: the products run on tiles
// padded to multiples of 8 and 16. The next chunk's B is not prefetched:
// a second stage of B (66 KB) would leave room for one block per SM; the
// second resident block hides the loads instead. Rows are padded to
// 4 mod 16 floats, so the fragment reads hit distinct banks. The group of
// head h is read as h / (heads / groups), so B and C are never expanded.
// TMA and wgmma are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int PS = 32;      // rows of p per block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LDB = MAXN + 4;   // B rows
constexpr int LDX = PS + 4;     // x rows
constexpr int LDS = MAXN + 4;   // state rows
constexpr int KN = MAXN / 8;    // most k-steps over n
constexpr int QT = MAXQ / 8;    // most 8-column score tiles of a chunk
constexpr int PT = PS / 8;      // n-tiles of y over p
constexpr float LOG2E = 1.4426950408889634f;
static_assert(MAXQ == 4 * 32, "the cum scan gives each lane four steps");
static_assert(MAXQ / 16 == 2 * WARPS, "each warp takes two row tiles");
static_assert(MAXN / 8 == 4 * WARPS, "each warp updates four column tiles");

struct Smem {
  float bs[MAXQ][LDB];   // B of the chunk
  float xs[MAXQ][LDX];   // x of the chunk, the block's rows of p
  float st[PS][LDS];     // the block's slice of the state
  float cum[MAXQ];       // cumulative dt * A within the chunk
  float dts[MAXQ];       // dt
  float wdt[MAXQ];       // dt * exp(cum_end - cum_s)
};

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ init_state,
    float* __restrict__ y, float* __restrict__ final_state,
    float* __restrict__ states, int64_t L,
    int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q, int64_t x_sb,
    int64_t x_sl, int64_t dt_sb, int64_t dt_sl, int64_t b_sb, int64_t b_sl,
    int64_t c_sb, int64_t c_sl, int vec_b, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * PS;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t grp = h / (H / G);
  const int pvalid = static_cast<int>(P - p0 < PS ? P - p0 : PS);
  const int nn = static_cast<int>(N), q = static_cast<int>(Q);
  const int NK = (nn + 7) / 8;           // k-steps over n
  const int Q8 = (q + 7) & ~7;           // the chunk padded to 8 rows
  const int MT = (q + 15) / 16;          // 16-row tiles of the chunk
  const int Q16 = MT * 16;
  // rows of B staged each chunk: the score tiles of the last row tile
  // reach 16 rows past it
  const int QB = Q16 + 16 < MAXQ ? Q16 + 16 : MAXQ;
  const float a = A[h];
  const float* xb = x + b * x_sb + h * P + p0;
  const float* dtb = dt + b * dt_sb + h;
  const float* bb = Bm + b * b_sb + grp * N;
  const float* cb = Cm + b * c_sb + grp * N;

  // The state slice: the initial state's rows, or zero; padding is zero.
  for (int e = tid; e < PS * LDS; e += THREADS) {
    const int pp = e / LDS, kk = e % LDS;
    float val = 0.f;
    if (init_state != nullptr && pp < pvalid && kk < nn)
      val = init_state[((b * H + h) * P + p0 + pp) * N + kk];
    sm.st[pp][kk] = val;
  }

  for (int64_t c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();   // the previous chunk's reads are done

    // -- the chunk's start state, (batch, chunk, head, p, n) ---------------
    if (states != nullptr) {
      float* dst = states + (((b * (L / Q) + c0 / Q) * H + h) * P + p0) * N;
      for (int i = tid; i < pvalid * nn; i += THREADS)
        dst[(i / nn) * N + i % nn] = sm.st[i / nn][i % nn];
    }

    // -- stage B, x and dt of the chunk ------------------------------------
    // Rows up to the chunk's last 16-row tile and every column of B are
    // written, zero past the chunk and n, so the products run on whole
    // tiles with no guard.
    if (vec_b) {
      // a thread keeps one 16-byte column chunk and walks the rows
      constexpr int C4 = MAXN / 4, STEP = THREADS / C4;
      const int cc = tid % C4;
      const bool col_ok = 4 * cc < nn;
      const float* src = bb + (c0 + tid / C4) * b_sl + 4 * cc;
      for (int s = tid / C4; s < QB; s += STEP, src += STEP * b_sl) {
        const bool valid = s < q && col_ok;
        cp_async16(&sm.bs[s][4 * cc], valid ? src : bb, valid);
      }
    } else {
      for (int e = tid; e < QB * MAXN; e += THREADS) {
        const int s = e / MAXN, kk = e % MAXN;
        const bool valid = s < q && kk < nn;
        cp_async4(&sm.bs[s][kk], valid ? bb + (c0 + s) * b_sl + kk : bb,
                  valid);
      }
    }
    if (vec_x) {
      constexpr int C4 = PS / 4, STEP = THREADS / C4;
      const int cc = tid % C4;
      const bool col_ok = 4 * cc < pvalid;
      const float* src = xb + (c0 + tid / C4) * x_sl + 4 * cc;
      for (int s = tid / C4; s < Q16; s += STEP, src += STEP * x_sl) {
        const bool valid = s < q && col_ok;
        cp_async16(&sm.xs[s][4 * cc], valid ? src : xb, valid);
      }
    } else {
      for (int e = tid; e < Q16 * PS; e += THREADS) {
        const int s = e / PS, pp = e % PS;
        const bool valid = s < q && pp < pvalid;
        cp_async4(&sm.xs[s][pp], valid ? xb + (c0 + s) * x_sl + pp : xb,
                  valid);
      }
    }
    for (int s = tid; s < MAXQ; s += THREADS)
      cp_async4(&sm.dts[s], s < q ? dtb + (c0 + s) * dt_sl : dtb, s < q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // -- cum and the state-update weights ----------------------------------
    if (warp == 0) {
      // each lane scans four consecutive steps, then the lanes' sums
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run += sm.dts[lane * 4 + e] * a;   // dt is 0 past the chunk
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
      const float cum_end = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = lane * 4 + e;
        const float c = excl + v[e];
        sm.cum[s] = s < q ? c : cum_end;
        sm.wdt[s] =
            s < q ? fast_exp2((cum_end - c) * LOG2E) * sm.dts[s] : 0.f;
      }
    }
    __syncthreads();

    // -- y: the diagonal block and the carried state -----------------------
    for (int half = 0; half < 2; ++half) {
      const int mi = half == 0 ? warp : 2 * WARPS - 1 - warp;
      if (mi >= MT) continue;
      const int tr0 = mi * 16 + g, tr1 = tr0 + 8;   // the lane's two rows
      // The tile's C rows as A fragments over n, raw fp32, zero past n.
      float cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk < NK) {
          const int col = kk * 8 + t;
          const float* r0p = cb + (c0 + tr0) * c_sl;
          const float* r1p = cb + (c0 + tr1) * c_sl;
          const bool ok0 = tr0 < q, ok1 = tr1 < q;
          cf[kk][0] = ok0 && col < nn ? r0p[col] : 0.f;
          cf[kk][1] = ok1 && col < nn ? r1p[col] : 0.f;
          cf[kk][2] = ok0 && col + 4 < nn ? r0p[col + 4] : 0.f;
          cf[kk][3] = ok1 && col + 4 < nn ? r1p[col + 4] : 0.f;
        }
      }
      const float cum0 = sm.cum[tr0], cum1 = sm.cum[tr1];

      // One pass over n gives the scores of every column tile on or below
      // the diagonal (in groups of four tiles, so two more above it when mi
      // is even; they are masked) and the carried state's term: each
      // k-step splits its C fragment once for both.
      const int ntl = 2 * mi + 2;
      float sc[QT][4];   // the row tile's score tiles
      float yo[PT][4];
#pragma unroll
      for (int jt = 0; jt < QT; ++jt)
        sc[jt][0] = sc[jt][1] = sc[jt][2] = sc[jt][3] = 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        yo[pt][0] = yo[pt][1] = yo[pt][2] = yo[pt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk < NK) {
          const FragA af = split_a(cf[kk][0], cf[kk][1], cf[kk][2],
                                   cf[kk][3]);
#pragma unroll
          for (int jb = 0; jb < QT; jb += 4) {
            if (jb < ntl) {
              FragB bf[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                bf[u] = load_b_nk(&sm.bs[0][0], LDB, (jb + u) * 8, kk * 8,
                                  lane);
              mma3_row<4>(&sc[jb], af, bf);
            }
          }
          FragB sf[PT];
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
            sf[pt] = load_b_nk(&sm.st[0][0], LDS, pt * 8, kk * 8, lane);
          mma3_row<PT>(yo, af, sf);
        }
      }

      // The diagonal block: each score tile decayed, times dt, and fed back
      // as the A operand against x.
      float yd[PT][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        yd[pt][0] = yd[pt][1] = yd[pt][2] = yd[pt][3] = 0.f;
#pragma unroll
      for (int jt = 0; jt < QT; ++jt) {
        if (jt < ntl) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = jt * 8 + 2 * t + (e & 1);
            const int tr = e < 2 ? tr0 : tr1;
            const float ct = e < 2 ? cum0 : cum1;
            w[e] = s <= tr && tr < q ? sc[jt][e] * sm.dts[s] *
                                           fast_exp2((ct - sm.cum[s]) * LOG2E)
                                     : 0.f;
          }
          const FragA pa = acc_as_a(w);
          FragB xf[PT];
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
            xf[pt] = load_b_paired(&sm.xs[0][0], LDX, jt * 8, pt * 8, lane);
          mma3_row<PT>(yd, pa, xf);
        }
      }

      const float e0 = fast_exp2(cum0 * LOG2E);
      const float e1 = fast_exp2(cum1 * LOG2E);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = e < 2 ? tr0 : tr1;
          const int pp = pt * 8 + 2 * t + (e & 1);
          if (tr < q && pp < pvalid)
            y[((b * L + c0 + tr) * H + h) * P + p0 + pp] =
                yd[pt][e] + (e < 2 ? e0 : e1) * yo[pt][e];
        }
      }
    }
    __syncthreads();   // every carried-state read of st is done

    // -- the state update: warp w owns column tiles w, w + 4, ... ----------
    // Padded columns of B and of the state are zero and stay zero.
    const float keep = fast_exp2(sm.cum[MAXQ - 1] * LOG2E);  // exp(cum_end)
    float sa[2][4][4];   // [row tile of p][column tile]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = (warp + WARPS * u) * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        sa[mt][u][0] = sm.st[r][c] * keep;
        sa[mt][u][1] = sm.st[r][c + 1] * keep;
        sa[mt][u][2] = sm.st[r + 8][c] * keep;
        sa[mt][u][3] = sm.st[r + 8][c + 1] * keep;
      }
    }
    for (int k0 = 0; k0 < Q8; k0 += 8) {
      const FragA xa[2] = {load_at_paired(&sm.xs[0][0], LDX, k0, 0, lane),
                           load_at_paired(&sm.xs[0][0], LDX, k0, 16, lane)};
      const float w0 = sm.wdt[k0 + 2 * t], w1 = sm.wdt[k0 + 2 * t + 1];
      FragB wb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wb[u] = load_b_paired(&sm.bs[0][0], LDB, k0, (warp + WARPS * u) * 8,
                              lane, w0, w1);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(sa[mt][u], xa[mt].small, wb[u].big);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(sa[mt][u], xa[mt].big, wb[u].small);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(sa[mt][u], xa[mt].big, wb[u].big);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = (warp + WARPS * u) * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        sm.st[r][c] = sa[mt][u][0];
        sm.st[r][c + 1] = sa[mt][u][1];
        sm.st[r + 8][c] = sa[mt][u][2];
        sm.st[r + 8][c + 1] = sa[mt][u][3];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < pvalid * nn; e += THREADS) {
    const int pp = e / nn, kk = e % nn;
    final_state[((b * H + h) * P + p0 + pp) * N + kk] = sm.st[pp][kk];
  }
}

}  // namespace

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init_state, void* y, void* final_state,
    void* states, int64_t batch, int64_t L, int64_t H, int64_t P, int64_t G, int64_t N,
    int64_t Q, int64_t x_sb, int64_t x_sl, int64_t dt_sb, int64_t dt_sl,
    int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl, void* stream) {
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || L % Q != 0 || G <= 0 ||
      H % G != 0 || batch > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !configured[device]) {
    err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) configured[device] = true;
  }
  // 16-byte copies where every row of B (and of the block's x slice)
  // starts on a 16-byte boundary.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_b = aligned(Bm) && N % 4 == 0 && b_sb % 4 == 0 &&
                    b_sl % 4 == 0;
  const int vec_x = aligned(x) && P % 4 == 0 && x_sb % 4 == 0 &&
                    x_sl % 4 == 0;
  const dim3 grid(static_cast<unsigned>((P + PS - 1) / PS),
                  static_cast<unsigned>(H), static_cast<unsigned>(batch));
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init_state),
      static_cast<float*>(y), static_cast<float*>(final_state),
      static_cast<float*>(states), L, H, P, G, N,
      Q, x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl, vec_b, vec_x);
  return static_cast<int>(cudaGetLastError());
}
