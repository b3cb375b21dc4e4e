// Backward of blockwise (flash) attention with grouped KV heads, fp32: given
// q, k, v, the forward's output o and row log-sum-exp lse (natural log,
// (B, H, Sq), from flash_attention.cu), and dO, it writes
//   P[i, j]  = exp(s[i, j] - lse[i]),  s[i, j] = q[i] . k[j] * D^-0.5
//   dv[j]   += sum_i P[i, j] dO[i]
//   dS[i, j] = P[i, j] (dO[i] . v[j] - D[i]),  D[i] = dO[i] . o[i]
//   dq[i]    = D^-0.5 sum_j dS[i, j] k[j]
//   dk[j]   += D^-0.5 sum_i dS[i, j] q[i]
// per query head h, with k and v read from (and dk, dv summed into) the kv
// head h / G. The masks are the forward's: causal (j > i masked) and a
// window (i - j >= window masked), so a masked pair has P = dS = 0; a row
// that sees no key at all (only with a window, i >= Skv - 1 + window) has
// every key at score -1e30 in the forward and so averages them all:
// P = 1 / Skv, dS = 0. Non-causal attention with Sq != Skv (cross
// attention) is the same arithmetic without a mask.
//
// The JAX package has no backward kernel: its trainer differentiates the
// plain jnp attention (src/repro/arch/layers.py:_sdpa). This is the
// backward of the port's forward kernel, which replaces
// src/repro/kernels/flash_attention.py:flash_attention_kernel.
//
// Bound on the H100: at the trainer's shape (Qwen2-0.5B, B = 8, S = 128,
// 14 query heads over 2 KV heads, D = 64, causal, fp32) it reads q, o, dO,
// k, v and lse and writes dq, dk, dv: about 16.8 MB, 5.0 us at 3.35 TB/s;
// the five products over the causal pairs are about 0.59 GFLOP, 3.6 us at
// the card's fp32-accurate product rate (3xTF32 on the tensor cores,
// 165 TFLOP/s; 8.8 us at the 67 TFLOP/s of fp32 on the CUDA cores, which
// this kernel uses). So it is bound by bytes.
//
// Design, simple and deterministic (no atomics): three kernels on one
// stream.
//   1. rowdot: D[i] = dO[i] . o[i], one warp a row.
//   2. dkdv: one block per (batch, kv head, 32 key rows) holds its K and V
//      tile in shared memory and its dk, dv sums in registers, and loops
//      over the G query heads of the kv head and, for each, the 64-row
//      query tiles that reach its keys (from the diagonal when causal, up
//      to the window's reach, plus rows that see no key). Each step
//      recomputes S and dO V^T for the 64 x 32 pair tile, forms P and dS
//      in shared memory, and adds P^T dO and dS^T Q.
//   3. dq: one block per (batch, head, 64 query rows) holds Q and dO and
//      loops over the 32-row key tiles the rows can see, adding dS K.
// Every product is fp32 FMA on the CUDA cores (no tensor cores), each
// thread a small register tile of the block's product over shared-memory
// operands whose rows are padded by one float so that both the row and
// the column reads of a warp hit distinct banks. The dkdv grid is small
// at the trainer's shape (B * KV * ceil(S / 32) = 64 blocks for 132 SMs)
// and each block walks the G heads in turn; the tensor cores (3xTF32 or
// wgmma), TMA and a split over the heads are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing (the wrapper passes D's (B, H, Sq) scratch) and
// returns the first non-zero cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per tile
constexpr int BKV = 32;         // key rows per tile
constexpr int LDP = BKV + 1;    // padded row of a P or dS tile, in floats
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dvec, *dq, *dk, *dv;
  int64_t Sq, Skv, H, KV, G;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int64_t osb, oss, osh, dsb, dss, dsh;
  int causal;
  int64_t window;
  float scale, scale_log2;
};

// D[(b * H + h) * Sq + i] = dO[b, i, h] . o[b, i, h]: one warp a row, the
// rows (b, i, h) in memory order.
__global__ void flash_attention_bwd_rowdot_kernel(Args a, int D,
                                                  int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp leaves together
  const int64_t h = row % a.H, i = row / a.H % a.Sq, b = row / (a.H * a.Sq);
  const float* o = a.o + b * a.osb + i * a.oss + h * a.osh;
  const float* d = a.dout + b * a.dsb + i * a.dss + h * a.dsh;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(o[c], d[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dvec[(b * a.H + h) * a.Sq + i] = s;
}

// `rows` rows of D floats from row r0 of `src` (row stride rs) into
// shared memory at a padded stride of D + 1, zero past row n.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t rs, int64_t r0, int64_t n,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int64_t row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? src[row * rs + c] : 0.f;
  }
}

// The block's M x N product over K, each thread a TM x TN register tile:
// acc[x][y] += sum_kk A(m, kk) B(n, kk) with m = tm + x * (M / TM),
// n = tn + y * (N / TN), A(m, kk) = A[m * am + kk * ak] and
// B(n, kk) = B[n * bn + kk * bk] in shared memory.
template <int M, int N, int TM, int TN, int K>
__device__ __forceinline__ void block_mm(float (&acc)[TM][TN],
                                         const float* A, int am, int ak,
                                         const float* B, int bn, int bk) {
  static_assert((M / TM) * (N / TN) == THREADS, "one tile a thread");
  constexpr int NT = N / TN;
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int x = 0; x < TM; ++x) av[x] = A[(tm + x * (M / TM)) * am + kk * ak];
#pragma unroll
    for (int y = 0; y < TN; ++y) bv[y] = B[(tn + y * NT) * bn + kk * bk];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// P and dS of the BQ x BKV pair tile (query rows from i0, keys from j0)
// into shared memory, from Q, dO (BQ rows), K, V (BKV rows), the rows'
// base-2 lse and D.
template <int D>
__device__ __forceinline__ void pair_tile(const Args& a, const float* Qs,
                                          const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse2s,
                                          const float* dvs, int64_t i0,
                                          int64_t j0, float* Ps, float* dSs) {
  constexpr int LD = D + 1, TM = 4, TN = 2, NT = BKV / TN;
  float s[TM][TN] = {}, dp[TM][TN] = {};
  block_mm<BQ, BKV, TM, TN, D>(s, Qs, LD, 1, Ks, LD, 1);
  block_mm<BQ, BKV, TM, TN, D>(dp, dOs, LD, 1, Vs, LD, 1);
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      const int r = tm + x * (BQ / TM), c = tn + y * NT;
      const int64_t i = i0 + r, j = j0 + c;
      float p = 0.f, ds = 0.f;
      if (i < a.Sq && j < a.Skv) {
        bool seen = true, nokey = false;
        if (a.causal) {
          seen = j <= i && (a.window == 0 || i - j < a.window);
          nokey = a.window > 0 && i >= a.Skv - 1 + a.window;
        }
        if (nokey) {
          p = 1.f / static_cast<float>(a.Skv);
        } else if (seen) {
          p = exp2f(s[x][y] * a.scale_log2 - lse2s[r]);
          ds = p * (dp[x][y] - dvs[r]);
        }
      }
      Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = ds;
    }
  }
}

// Q, dO, base-2 lse and D of the query tile at i0 of head h.
template <int D>
__device__ __forceinline__ void load_query_tile(const Args& a, int64_t b,
                                                int64_t h, int64_t i0,
                                                float* Qs, float* dOs,
                                                float* lse2s, float* dvs) {
  load_rows<D>(Qs, a.q + b * a.qsb + h * a.qsh, a.qss, i0, a.Sq, BQ);
  load_rows<D>(dOs, a.dout + b * a.dsb + h * a.dsh, a.dss, i0, a.Sq, BQ);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int64_t i = i0 + r, at = (b * a.H + h) * a.Sq + i;
    lse2s[r] = i < a.Sq ? a.lse[at] * LOG2E : 0.f;
    dvs[r] = i < a.Sq ? a.dvec[at] : 0.f;
  }
}

template <int D>
struct Smem {
  // K, V (BKV rows), Q, dO (BQ rows), P, dS, then the rows' lse and D
  static constexpr int FLOATS =
      (2 * BKV + 2 * BQ) * (D + 1) + 2 * BQ * LDP + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dkdv_kernel(Args a) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse2s = dSs + BQ * LDP;
  float* dvs = lse2s + BQ;

  const int64_t b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BKV;
  load_rows<D>(Ks, a.k + b * a.ksb + kvh * a.ksh, a.kss, j0, a.Skv, BKV);
  load_rows<D>(Vs, a.v + b * a.vsb + kvh * a.vsh, a.vss, j0, a.Skv, BKV);

  // Query rows that reach this key tile: [qlo, qhi) and the rows from
  // `nokey` on, which see no key and so average every key.
  int64_t qlo = 0, qhi = a.Sq, nokey = a.Sq;
  if (a.causal) {
    qlo = j0;
    if (a.window > 0) {
      qhi = j0 + BKV - 1 + a.window < a.Sq ? j0 + BKV - 1 + a.window : a.Sq;
      nokey = a.Skv - 1 + a.window;
    }
  }
  constexpr int TM = 2, TN = D / 16;   // 16 x 16 threads over BKV x D
  float dk[TM][TN] = {}, dv[TM][TN] = {};
  for (int64_t hh = 0; hh < a.G; ++hh) {
    const int64_t h = kvh * a.G + hh;
    for (int64_t i0 = qlo / BQ * BQ; i0 < a.Sq; i0 += BQ) {
      if (i0 >= qhi && i0 + BQ <= nokey) continue;
      __syncthreads();   // the last step's products are done with the tiles
      load_query_tile<D>(a, b, h, i0, Qs, dOs, lse2s, dvs);
      __syncthreads();
      pair_tile<D>(a, Qs, dOs, Ks, Vs, lse2s, dvs, i0, j0, Ps, dSs);
      __syncthreads();
      block_mm<BKV, D, TM, TN, BQ>(dv, Ps, 1, LDP, dOs, 1, LD);
      block_mm<BKV, D, TM, TN, BQ>(dk, dSs, 1, LDP, Qs, 1, LD);
    }
  }
  constexpr int NT = D / TN;
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int64_t j = j0 + tm + x * (BKV / TM);
    if (j >= a.Skv) continue;
    const int64_t row = ((b * a.Skv + j) * a.KV + kvh) * D;
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      a.dk[row + tn + y * NT] = dk[x][y] * a.scale;
      a.dv[row + tn + y * NT] = dv[x][y];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dq_kernel(Args a) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse2s = dSs + BQ * LDP;
  float* dvs = lse2s + BQ;

  const int64_t b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * BQ;
  load_query_tile<D>(a, b, h, i0, Qs, dOs, lse2s, dvs);

  // Key tiles the rows see: up to the diagonal when causal, from the
  // window's first key with one (a row that sees no key has dS = 0).
  int64_t lo = 0, hi = a.Skv;
  if (a.causal) {
    const int64_t last = (i0 + BQ < a.Sq ? i0 + BQ : a.Sq) - 1;
    hi = last + 1 < a.Skv ? last + 1 : a.Skv;
    if (a.window > 0) {
      const int64_t first = i0 - a.window + 1;
      lo = first > 0 ? first / BKV * BKV : 0;
    }
  }
  constexpr int TM = 4, TN = D / 16;   // 16 x 16 threads over BQ x D
  float dq[TM][TN] = {};
  const float* kb = a.k + b * a.ksb + kvh * a.ksh;
  const float* vb = a.v + b * a.vsb + kvh * a.vsh;
  for (int64_t j0 = lo; j0 < hi; j0 += BKV) {
    __syncthreads();   // the last step's product is done with K and dS
    load_rows<D>(Ks, kb, a.kss, j0, a.Skv, BKV);
    load_rows<D>(Vs, vb, a.vss, j0, a.Skv, BKV);
    __syncthreads();
    pair_tile<D>(a, Qs, dOs, Ks, Vs, lse2s, dvs, i0, j0, Ps, dSs);
    __syncthreads();
    block_mm<BQ, D, TM, TN, BKV>(dq, dSs, LDP, 1, Ks, 1, LD);
  }
  constexpr int NT = D / TN;
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int64_t i = i0 + tm + x * (BQ / TM);
    if (i >= a.Sq) continue;
    const int64_t row = ((b * a.Sq + i) * a.H + h) * D;
#pragma unroll
    for (int y = 0; y < TN; ++y) a.dq[row + tn + y * NT] = dq[x][y] * a.scale;
  }
}

// The shared-memory limit is a per-device attribute: set it once on each
// device a launch reaches, for both kernels of a head dim.
template <int D>
cudaError_t configure() {
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES) configured[device] = true;
  return cudaSuccess;
}

template <int D>
int launch(const Args& a, int64_t B, cudaStream_t stream) {
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = B * a.Sq * a.H;
  flash_attention_bwd_rowdot_kernel<<<
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32)),
      THREADS, 0, stream>>>(a, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_kernel<D><<<
      dim3(static_cast<unsigned>(B * a.KV),
           static_cast<unsigned>((a.Skv + BKV - 1) / BKV)),
      THREADS, Smem<D>::BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq_kernel<D><<<
      dim3(static_cast<unsigned>(B * a.H),
           static_cast<unsigned>((a.Sq + BQ - 1) / BQ)),
      THREADS, Smem<D>::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
    int64_t D, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh, int64_t dsb, int64_t dss,
    int64_t dsh, int64_t causal, int64_t window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      (Sq + BQ - 1) / BQ > 65535 || (Skv + BKV - 1) / BKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.qsb = qsb, a.qss = qss, a.qsh = qsh;
  a.ksb = ksb, a.kss = kss, a.ksh = ksh;
  a.vsb = vsb, a.vss = vss, a.vsh = vsh;
  a.osb = osb, a.oss = oss, a.osh = osh;
  a.dsb = dsb, a.dss = dss, a.dsh = dsh;
  a.causal = causal ? 1 : 0;
  a.window = window;
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  a.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));   // as the forward's
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(a, B, st);
    case 32:
      return launch<32>(a, B, st);
    case 64:
      return launch<64>(a, B, st);
    case 128:
      return launch<128>(a, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
