// Chunked SSD scan (Mamba-2), fp32. Per head, with the state S (p, n)
// starting at zero and cum the within-chunk cumulative sum of dt * A:
//   y[t]   = sum_{s <= t in chunk} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//            + exp(cum_t) S C_t
//   S     <- S exp(cum_end) + sum_s x_s dt_s exp(cum_end - cum_s) B_s^T
// chunk after chunk; the final S is written out for the decode cache.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// (grid (batch, head blocks, chunks) with the chunk axis sequential and
// the (heads, p, n) state in VMEM scratch; B and C expanded to heads by
// the caller; the final state not written).
//
// Bound on the H100: operations. At the path's shapes (Mamba2-130m
// prefill: 24 heads, p = 64, n = 128, chunk 128, one group) one chunk of
// one head needs at least 5.2 MFLOP, the sequential recurrence's count
// (per step and state entry a decay multiply, a multiply-add for the
// update and one for C . state; the chunked algorithm here does 7.4 MFLOP,
// as it also forms the masked C.B^T scores), against about 70 KB of x, y
// and its share of B and C: some 75 FLOP per byte, far above the card's
// fp32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).
// Parallelism is the harder limit: b * h is 24 per request against
// 132 SMs.
//
// Design: one block per (batch, head, 16 rows of p). Each state row
// evolves on its own, so a block carries a 16 x n slice of the state in
// shared memory through a loop over the chunks (the loop takes the place
// of the TPU grid's sequential chunk axis) and four blocks cover a head,
// at the price of computing the chunk's C.B^T scores in each. Per chunk
// the block stages B transposed (n x chunk) and x * dt for its 16 rows,
// then walks the chunk in sub-blocks of 32 output rows: C rows, the
// 32 x chunk scores (each warp four rows, each lane four columns, skipping
// column blocks wholly above the diagonal), then y for those rows. The
// decay exp(cum_t - cum_s) is computed only where s <= t: the TPU kernel
// computes it everywhere and masks afterwards, where for s > t the
// exponent is positive and can overflow. Shared arrays are padded to an
// odd row stride so column walks hit distinct banks. The group of head h
// is read as h / (heads / groups), so B and C are never expanded. About
// 114 KB of shared memory: one block per SM. The state starts at zero.
// Tensor cores (wgmma) and TMA are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int PS = 16;      // rows of p per block
constexpr int TR = 32;      // output rows per sub-block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(TR == 4 * WARPS, "each warp computes four score rows");
static_assert(MAXQ == 4 * 32, "each lane computes four score columns");
static_assert(THREADS == 2 * MAXN && THREADS / PS == TR / 2,
              "thread maps of the y and state phases");

struct Smem {
  float bt[MAXN][MAXQ + 1];   // B of the chunk, transposed
  float cs[TR][MAXN + 1];     // C rows of the sub-block
  float sc[TR][MAXQ + 1];     // masked, decayed scores of the sub-block
  float st[PS][MAXN + 1];     // the block's slice of the state
  float xdt[MAXQ][PS];        // x * dt for the block's rows of p
  float cum[MAXQ];            // cumulative dt * A within the chunk
  float dend[MAXQ];           // exp(cum_end - cum_s)
};

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ final_state, int64_t L, int64_t H, int64_t P,
    int64_t G, int64_t N, int64_t Q, int64_t x_sb, int64_t x_sl,
    int64_t dt_sb, int64_t dt_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb,
    int64_t c_sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * PS;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t grp = h / (H / G);
  const float a = A[h];
  const float* xb = x + b * x_sb + h * P;
  const float* dtb = dt + b * dt_sb + h;
  const float* bb = Bm + b * b_sb + grp * N;
  const float* cb = Cm + b * c_sb + grp * N;

  for (int e = tid; e < PS * (MAXN + 1); e += THREADS)
    (&sm.st[0][0])[e] = 0.f;

  for (int64_t c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();   // the previous chunk's reads are done
    if (warp == 0) {
      // cum: each lane scans four consecutive steps, then the lanes' sums.
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        const float d = t < Q ? dtb[(c0 + t) * dt_sl] : 0.f;
        run += d * a;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < Q) sm.cum[t] = excl + v[e];
      }
    }
    // Global loads are unrolled so that several are in flight at once.
#pragma unroll 8
    for (int64_t e = tid; e < Q * N; e += THREADS) {
      const int64_t s = e / N, kk = e % N;
      sm.bt[kk][s] = bb[(c0 + s) * b_sl + kk];
    }
#pragma unroll 8
    for (int64_t e = tid; e < Q * PS; e += THREADS) {
      const int64_t s = e / PS, pp = e % PS;
      const int64_t t = c0 + s;
      sm.xdt[s][pp] =
          p0 + pp < P ? xb[t * x_sl + p0 + pp] * dtb[t * dt_sl] : 0.f;
    }
    __syncthreads();
    const float cum_end = sm.cum[Q - 1];
    if (tid < Q) sm.dend[tid] = expf(cum_end - sm.cum[tid]);

    for (int64_t t0 = 0; t0 < Q; t0 += TR) {
#pragma unroll 8
      for (int64_t e = tid; e < TR * N; e += THREADS) {
        const int64_t tt = e / N, kk = e % N;
        sm.cs[tt][kk] = t0 + tt < Q ? cb[(c0 + t0 + tt) * c_sl + kk] : 0.f;
      }
      __syncthreads();

      // Scores: warp w takes rows 4w..4w+3 of the sub-block, lane the
      // columns lane + 32 jb; column blocks past the sub-block's last row
      // lie above the diagonal and are skipped.
      const int nb = static_cast<int>(t0 / 32) + 1;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) acc[r][jb] = 0.f;
#pragma unroll 4
      for (int64_t kk = 0; kk < N; ++kk) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sm.cs[4 * warp + r][kk];
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (jb < nb) {
            const float bv = sm.bt[kk][lane + 32 * jb];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][jb] = fmaf(cv[r], bv, acc[r][jb]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tt = 4 * warp + r;
        const int64_t t = t0 + tt;
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (jb < nb) {
            const int s = lane + 32 * jb;
            sm.sc[tt][s] = (s <= t && t < Q)
                               ? acc[r][jb] * expf(sm.cum[t] - sm.cum[s])
                               : 0.f;
          }
        }
      }
      __syncthreads();

      // y for rows tt and tt + TR / 2 of one column pp per thread: the
      // diagonal block plus the carried state's contribution,
      // exp(cum_t) S C_t. The two rows share each x * dt and state load,
      // and both sums run to the later row's diagonal (the earlier row's
      // scores are 0 past its own).
      const int pp = tid % PS;
      const int ta = tid / PS, tb = ta + TR / 2;
      const int64_t t_a = t0 + ta, t_b = t0 + tb;
      if (t_a < Q) {
        const int64_t last = t_b < Q ? t_b : t_a;
        float yda = 0.f, ydb = 0.f, yoa = 0.f, yob = 0.f;
#pragma unroll 4
        for (int64_t s = 0; s <= last; ++s) {
          const float xv = sm.xdt[s][pp];
          yda = fmaf(sm.sc[ta][s], xv, yda);
          ydb = fmaf(sm.sc[tb][s], xv, ydb);
        }
#pragma unroll 4
        for (int64_t kk = 0; kk < N; ++kk) {
          const float sv = sm.st[pp][kk];
          yoa = fmaf(sm.cs[ta][kk], sv, yoa);
          yob = fmaf(sm.cs[tb][kk], sv, yob);
        }
        if (p0 + pp < P) {
          float* yp = y + ((b * L + c0 + t_a) * H + h) * P + p0 + pp;
          *yp = yda + expf(sm.cum[t_a]) * yoa;
          if (t_b < Q)
            yp[(TR / 2) * H * P] = ydb + expf(sm.cum[t_b]) * yob;
        }
      }
      __syncthreads();   // cs and sc are rewritten by the next sub-block
    }

    // State update: thread -> state column kk, rows tid / MAXN + 2 i.
    const int kk = tid % MAXN;
    if (kk < N) {
      const float keep = expf(cum_end);
      float acc_s[PS / 2];
#pragma unroll
      for (int i = 0; i < PS / 2; ++i)
        acc_s[i] = sm.st[tid / MAXN + 2 * i][kk] * keep;
#pragma unroll 4
      for (int64_t s = 0; s < Q; ++s) {
        const float w = sm.bt[kk][s] * sm.dend[s];
#pragma unroll
        for (int i = 0; i < PS / 2; ++i)
          acc_s[i] = fmaf(w, sm.xdt[s][tid / MAXN + 2 * i], acc_s[i]);
      }
#pragma unroll
      for (int i = 0; i < PS / 2; ++i) sm.st[tid / MAXN + 2 * i][kk] = acc_s[i];
    }
  }
  __syncthreads();
  for (int64_t e = tid; e < PS * N; e += THREADS) {
    const int64_t pp = e / N, kk = e % N;
    if (p0 + pp < P)
      final_state[((b * H + h) * P + p0 + pp) * N + kk] = sm.st[pp][kk];
  }
}

}  // namespace

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* final_state, int64_t batch, int64_t L,
    int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q, int64_t x_sb,
    int64_t x_sl, int64_t dt_sb, int64_t dt_sl, int64_t b_sb, int64_t b_sl,
    int64_t c_sb, int64_t c_sl, void* stream) {
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
  const dim3 grid(static_cast<unsigned>((P + PS - 1) / PS),
                  static_cast<unsigned>(H), static_cast<unsigned>(batch));
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(final_state), L, H, P, G, N, Q, x_sb, x_sl, dt_sb,
      dt_sl, b_sb, b_sl, c_sb, c_sl);
  return static_cast<int>(cudaGetLastError());
}
