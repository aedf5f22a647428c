// K4: backward of the ByteNet residual block (K2), as eleven launches.
//
// Replaces hudiff_tpu/ops/pallas_bytenet.py::_bwd_kernel (called through
// _pallas_bwd, the backward of the custom VJP around K2).
//
// What it computes, from the block input x, the saved pre-LayerNorm outputs
// p (Dense) and q (conv), the f32 parameters and dy, with LN = f32 LayerNorm
// (eps 1e-6, var = E[z^2] - E[z]^2), act' the activation's derivative
// (ReLU: u > 0; GELU: exact erf, cdf + u pdf), cd the activation type and
// every product of cd values accumulated in f32:
//   a = cd(act(LN1 x)), bb = cd(act(LN2 p)), e = cd(act(LN3 q))   recomputed
//   de  = dy W2                     dW2 = dy^T e, dc2 = sum dy
//   dwh = de act'(wh)               dg3 = sum dwh n3, db3 = sum dwh
//   dq  = LN3^T(dwh g3)             dcc = sum dq
//   dbb = sum_t shift_-t(cd(dq)) Wc[:, t, :]     (zero outside the chain)
//                                   dWc[:, t, :] = cd(dq)^T shift_t(bb)
//   dvh = dbb act'(vh)              dg2, db2 as above
//   dp  = LN2^T(dvh g2)             dc1 = sum dp
//   da  = cd(dp) W1                 dW1 = cd(dp)^T a
//   duh = da act'(uh)               dg1, db1 as above
//   dx  = cd(dy + LN1^T(duh g1))
// where LN^T(d) = (d - mean(d) - n mean(d n)) / sigma, and the sums run over
// all B*L rows. Weights arrive in f32 and are rounded to cd as they are
// staged, as the TPU kernel casts its f32 weights; the gradients are f32.
//
// What bounds it on an H100: operations. The backward executes twice the
// forward's products (data and weight gradients): for the 768/384 block at
// B=128, L=152, about 126 GFLOP, 0.128 ms at 989 TFLOP/s bf16, against
// about 100 MB of inputs and outputs (0.03 ms at 3.35 TB/s).
//
// Design: the TPU kernel accumulated the 12 parameter gradients across its
// sequential batch-tile grid; on Hopper that is a reduction over B*L rows
// (19,456 at B=128, L=152) across blocks that run in no order. Following
// K2's split, the work is row passes and GEMMs over the flattened rows, and
// every cross-row sum is a fixed-order two-step reduction, with no atomics,
// so a run reproduces bit for bit:
//   1. bytenet_bwd_ln_act_kernel: a, bb, e (three jobs, one launch)
//   2. bytenet_bwd_gemm_kernel:   de = dy W2                 (f32 out)
//   3. bytenet_bwd_wgrad_kernel:  dW2 partials, split over the rows
//   4. bytenet_bwd_rows_kernel:   dq, dg3/db3/dcc partials per 64-row block
//   5. gemm, conv-transposed A:   dbb (rows gathered per tap in the opposite
//                                 direction of the forward, zero outside
//                                 the chain)
//   6. wgrad, gathered B:         dWc partials
//   7. rows:                      dp, dg2/db2/dc1 partials
//   8. gemm:                      da = dp W1
//   9. wgrad:                     dW1 partials
//  10. rows:                      dx, dg1/db1/dc2 partials
//  11. bytenet_bwd_sum_kernel:    every partial summed in a fixed order
// The weight-gradient GEMMs have depth B*L and small outputs ([768, 384]
// up to [384, 7*384]), so their rows are split into chunks to give ~264
// blocks, each writing its own f32 partial; the row passes write one
// partial per 64 rows. The port has no length padding: rows outside a chain
// read as zeros through bound checks, which is what the TPU kernel's
// row masks (_row_mask) achieve on its padded rows. GEMM tiles are 64 x 64
// over 4 warps on WMMA 16x16x16 bf16 fragments with f32 accumulators
// (A staged transposed for the weight gradients, read as a column-major
// fragment); f32 inputs take a plain FMA path so they stay exact. Staging
// is synchronous: a simple kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth per staged chunk
constexpr int WARPS = 4;      // 2 x 2 warps, each owns a 32 x 32 sub-tile
constexpr int THREADS = WARPS * 32;
constexpr int LDC = BN + 4;   // f32 output tile row stride
constexpr int LN_ROWS = 8;    // recompute pass: one warp per row
constexpr int ROW_WARPS = 8;  // backward row passes: 8 warps per block ...
constexpr int ROW_BLOCK = 64; // ... over 64 rows, one column partial each
constexpr int MAXJ = 32;      // row passes: widths up to 32 lanes x 32
constexpr int WGRAD_BLOCKS = 264;  // target blocks of a weight-gradient GEMM
constexpr float LN_EPS = 1e-6f;
enum { A_ROWS = 0, A_CONVT = 1 };  // data GEMM: A rows, or conv-transposed gather
enum { Y_ROWS = 0, Y_CONV = 1 };   // weight GEMM: Y rows, or conv gather

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int PAD = 4, VEC = 4; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8, VEC = 8; };

template <typename T> struct Pack {
  uint4 u;
  __device__ __forceinline__ T& operator[](int i) { return reinterpret_cast<T*>(&u)[i]; }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float act_fn(float u, int gelu) {
  return gelu ? 0.5f * u * (1.f + erff(u * 0.70710678118654752f)) : fmaxf(u, 0.f);
}
__device__ __forceinline__ float dact_fn(float u, int gelu) {
  if (!gelu) return u > 0.f ? 1.f : 0.f;
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  const float pdf = expf(-0.5f * u * u) * 0.39894228040143268f;
  return cdf + u * pdf;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// ---------------------------------------------------------------------------
// 1. recompute a, bb, e: out = cd(act(LN(in))), one warp per row
// ---------------------------------------------------------------------------

template <typename T> struct LnJob {
  const T* in;
  const float* g;
  const float* b;
  T* out;
  int n;
};
template <typename T> struct LnJobs { LnJob<T> job[3]; };

template <typename T>
__global__ void __launch_bounds__(LN_ROWS * 32)
bytenet_bwd_ln_act_kernel(LnJobs<T> jobs, int M, int gelu) {
  constexpr int V = Cfg<T>::VEC;
  const LnJob<T> jb = jobs.job[blockIdx.y];
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (m >= M) return;
  const T* row = jb.in + (size_t)m * jb.n;
  float s = 0.f, s2 = 0.f;
  for (int c = lane * V; c < jb.n; c += 32 * V) {
    Pack<T> p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f(p[e]);
      s += v;
      s2 += v * v;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / jb.n;
  const float inv = rsqrtf(fmaxf(s2 / jb.n - mean * mean, 0.f) + LN_EPS);
  for (int c = lane * V; c < jb.n; c += 32 * V) {
    Pack<T> p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int e = 0; e < V; ++e)
      p[e] = from_f<T>(act_fn((to_f(p[e]) - mean) * inv * jb.g[c + e] + jb.b[c + e], gelu));
    *reinterpret_cast<uint4*>(jb.out + (size_t)m * jb.n + c) = p.u;
  }
}

// ---------------------------------------------------------------------------
// 4, 7, 10. LayerNorm + activation backward, row by row, with column partials
// ---------------------------------------------------------------------------

template <typename T> struct RowArgs {
  const float* dz;   // [M, n] f32: gradient at the activation's output
  const T* z;        // [M, n]: the LayerNorm's input
  const float* g;
  const float* b;
  const T* res;      // [M, n] residual gradient added to the result, or nullptr
  T* out;            // [M, n] = cd([res +] LN^T(dz act'(h) g))
  float* part;       // [3][nblk][n]: sum dh n, sum dh, sum (res ? res : result)
  int M, n, gelu;
};

// this block's partial of one column quantity: the 8 warps' sums in order
__device__ __forceinline__ void block_partial(const float (&v)[MAXJ], float (*red)[MAXJ * 32],
                                              float* dst, int n, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (j * 32 < n) red[warp][lane + 32 * j] = v[j];
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += ROW_WARPS * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) t += red[w][c];
    dst[c] = t;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) bytenet_bwd_rows_kernel(RowArgs<T> a) {
  __shared__ float red[ROW_WARPS][MAXJ * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n = a.n;
  const float inv_n = 1.f / n;
  float pg[MAXJ], pb[MAXJ], pc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) pg[j] = pb[j] = pc[j] = 0.f;
  constexpr int PER_WARP = ROW_BLOCK / ROW_WARPS;
  for (int i = 0; i < PER_WARP; ++i) {
    const int m = blockIdx.x * ROW_BLOCK + warp * PER_WARP + i;
    if (m >= a.M) continue;
    const T* zr = a.z + (size_t)m * n;
    const float* dzr = a.dz + (size_t)m * n;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j * 32 < n) {
        const float v = to_f(zr[lane + 32 * j]);
        s += v;
        s2 += v * v;
      }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s * inv_n;
    const float inv = rsqrtf(fmaxf(s2 * inv_n - mean * mean, 0.f) + LN_EPS);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j * 32 < n) {
        const int c = lane + 32 * j;
        const float nz = (to_f(zr[c]) - mean) * inv;
        const float dh = dzr[c] * dact_fn(nz * a.g[c] + a.b[c], a.gelu);
        const float dn = dh * a.g[c];
        m1 += dn;
        m2 += dn * nz;
        pg[j] += dh * nz;
        pb[j] += dh;
      }
    m1 = warp_sum(m1) * inv_n;
    m2 = warp_sum(m2) * inv_n;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j * 32 < n) {
        const int c = lane + 32 * j;
        const float nz = (to_f(zr[c]) - mean) * inv;
        const float dn = dzr[c] * dact_fn(nz * a.g[c] + a.b[c], a.gelu) * a.g[c];
        const float d = (dn - m1 - nz * m2) * inv;
        if (a.res) {
          const float r = to_f(a.res[(size_t)m * n + c]);
          pc[j] += r;
          a.out[(size_t)m * n + c] = from_f<T>(r + d);
        } else {
          pc[j] += d;
          a.out[(size_t)m * n + c] = from_f<T>(d);
        }
      }
  }
  const size_t stride = (size_t)gridDim.x * n;
  float* dst = a.part + (size_t)blockIdx.x * n;
  block_partial(pg, red, dst, n, warp, lane);
  block_partial(pb, red, dst + stride, n, warp, lane);
  block_partial(pc, red, dst + 2 * stride, n, warp, lane);
}

// ---------------------------------------------------------------------------
// GEMM tile: a 64 x 64 f32 accumulator over 4 warps; warp w owns rows
// (w/2)*32, columns (w%2)*32. A is staged [BM][LDA] (A_T false) or
// transposed [BK][LDAT] (A_T true: A[m][k] = sA[k][m]); B is [BK][LDB].
// ---------------------------------------------------------------------------

template <typename T> constexpr int LDA = BK + Cfg<T>::PAD;
template <typename T> constexpr int LDAT = BM + Cfg<T>::PAD;
template <typename T> constexpr int LDB = BN + Cfg<T>::PAD;

template <typename T, bool A_T> struct Tile;

template <bool A_T> struct Tile<__nv_bfloat16, A_T> {
  using bf16 = __nv_bfloat16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void mma(const bf16* sA, const bf16* sB, int warp, int) {
    const int r0 = (warp / 2) * 32, c0 = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sB + kk * LDB<bf16> + c0 + 16 * j, LDB<bf16>);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (A_T) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, sA + kk * LDAT<bf16> + r0 + 16 * i, LDAT<bf16>);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sA + (r0 + 16 * i) * LDA<bf16> + kk, LDA<bf16>);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
  }
  __device__ void store(float* sC, int warp, int) {
    const int r0 = (warp / 2) * 32, c0 = (warp % 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (r0 + 16 * i) * LDC + c0 + 16 * j, acc[i][j], LDC,
                                wmma::mem_row_major);
  }
};

// f32: lane owns 4 rows x 8 columns of its warp's 32 x 32 sub-tile.
template <bool A_T> struct Tile<float, A_T> {
  float acc[4][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void mma(const float* sA, const float* sB, int warp, int lane) {
    const int r0 = (warp / 2) * 32 + (lane / 4) * 4, c0 = (warp % 2) * 32 + (lane % 4) * 8;
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_T ? sA[kk * LDAT<float> + r0 + i] : sA[(r0 + i) * LDA<float> + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[kk * LDB<float> + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* sC, int warp, int lane) {
    const int r0 = (warp / 2) * 32 + (lane / 4) * 4, c0 = (warp % 2) * 32 + (lane % 4) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sC[(r0 + i) * LDC + c0 + j] = acc[i][j];
  }
};

// ---------------------------------------------------------------------------
// 2, 5, 8. data-gradient GEMM: out[M, N] f32 = A[M, Kd] (cd) x W[Kd, N] (f32,
// rounded to cd as it is staged)
// ---------------------------------------------------------------------------

template <typename T> struct GemmArgs {
  const T* a;          // A_ROWS: [M, Kd]; A_CONVT: dq [M, H], Kd = K*H
  const float* w;      // A_ROWS: [Kd, N] row-major; A_CONVT: wc [H, K, H]
  float* out;          // [M, N]
  int M, Kd, N;
  int L, H, K, dil;    // A_CONVT: chain length, channels, taps, dilation
};

template <typename T, int AMODE>
__global__ void __launch_bounds__(THREADS) bytenet_bwd_gemm_kernel(GemmArgs<T> p) {
  constexpr int V = Cfg<T>::VEC;
  __shared__ __align__(128) T sA[BM * LDA<T>];
  __shared__ __align__(128) T sB[BK * LDB<T>];
  __shared__ __align__(128) float sC[BM * LDC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Tile<T, false> tile;
  tile.zero();
  for (int k0 = 0; k0 < p.Kd; k0 += BK) {
    // A: 64 rows x 32 depth, 16-byte vectors
    for (int idx = threadIdx.x; idx < BM * (BK / V); idx += THREADS) {
      const int r = idx / (BK / V), k = k0 + (idx % (BK / V)) * V, m = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < p.M) {
        if (AMODE == A_ROWS) {
          v = *reinterpret_cast<const uint4*>(p.a + (size_t)m * p.Kd + k);
        } else {
          // tap t of the transposed conv reads row m - shift_t of the chain
          const int t = k / p.H, o = k % p.H;
          const int shift = (t - (p.K - 1) / 2) * p.dil;
          const int ls = m % p.L - shift;
          if (ls >= 0 && ls < p.L)
            v = *reinterpret_cast<const uint4*>(p.a + (size_t)(m - shift) * p.H + o);
        }
      }
      *reinterpret_cast<uint4*>(sA + r * LDA<T> + (idx % (BK / V)) * V) = v;
    }
    // B: 32 depth rows x 64 columns of f32 weights, rounded to T
    for (int idx = threadIdx.x; idx < BK * (BN / 4); idx += THREADS) {
      const int kr = idx / (BN / 4), c = (idx % (BN / 4)) * 4, k = k0 + kr, n = n0 + c;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < p.N) {
        const float* row = AMODE == A_ROWS
                               ? p.w + (size_t)k * p.N
                               : p.w + ((size_t)(k % p.H) * p.K + k / p.H) * p.H;
        w = *reinterpret_cast<const float4*>(row + n);
      }
      T* dst = sB + kr * LDB<T> + c;
      dst[0] = from_f<T>(w.x), dst[1] = from_f<T>(w.y);
      dst[2] = from_f<T>(w.z), dst[3] = from_f<T>(w.w);
    }
    __syncthreads();
    tile.mma(sA, sB, warp, lane);
    __syncthreads();
  }
  tile.store(sC, warp, lane);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m < p.M && n < p.N) p.out[(size_t)m * p.N + n] = sC[r * LDC + c];
  }
}

// ---------------------------------------------------------------------------
// 3, 6, 9. weight-gradient GEMM: part[s][P, Q] = sum over rows m of chunk s
// of X[m, P] (cd) x Y[m, Q] (cd)
// ---------------------------------------------------------------------------

template <typename T> struct WgradArgs {
  const T* x;          // [M, P]
  const T* y;          // Y_ROWS: [M, Q]; Y_CONV: bb [M, H], Q = K*H
  float* part;         // [S][P][Q]
  int M, P, Q, chunk;  // rows per split (a multiple of BK)
  int L, H, K, dil;    // Y_CONV: chain length, channels, taps, dilation
};

template <typename T, int YMODE>
__global__ void __launch_bounds__(THREADS) bytenet_bwd_wgrad_kernel(WgradArgs<T> p) {
  constexpr int V = Cfg<T>::VEC;
  __shared__ __align__(128) T sA[BK * LDAT<T>];
  __shared__ __align__(128) T sB[BK * LDB<T>];
  __shared__ __align__(128) float sC[BM * LDC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * BM, q0 = blockIdx.y * BN, s = blockIdx.z;
  const int mb = s * p.chunk, me = min(p.M, mb + p.chunk);
  Tile<T, true> tile;
  tile.zero();
  for (int k0 = mb; k0 < me; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * (BM / V); idx += THREADS) {
      const int kr = idx / (BM / V), c = (idx % (BM / V)) * V, m = k0 + kr;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < me && p0 + c < p.P)
        v = *reinterpret_cast<const uint4*>(p.x + (size_t)m * p.P + p0 + c);
      *reinterpret_cast<uint4*>(sA + kr * LDAT<T> + c) = v;
    }
    for (int idx = threadIdx.x; idx < BK * (BN / V); idx += THREADS) {
      const int kr = idx / (BN / V), c = (idx % (BN / V)) * V, m = k0 + kr, q = q0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < me && q < p.Q) {
        if (YMODE == Y_ROWS) {
          v = *reinterpret_cast<const uint4*>(p.y + (size_t)m * p.Q + q);
        } else {
          // column (t, i) is bb[m + shift_t][i] of the same chain, else zero
          const int t = q / p.H, i = q % p.H;
          const int shift = (t - (p.K - 1) / 2) * p.dil;
          const int ls = m % p.L + shift;
          if (ls >= 0 && ls < p.L)
            v = *reinterpret_cast<const uint4*>(p.y + (size_t)(m + shift) * p.H + i);
        }
      }
      *reinterpret_cast<uint4*>(sB + kr * LDB<T> + c) = v;
    }
    __syncthreads();
    tile.mma(sA, sB, warp, lane);
    __syncthreads();
  }
  tile.store(sC, warp, lane);
  __syncthreads();
  float* dst = p.part + (size_t)s * p.P * p.Q;
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, pp = p0 + r, q = q0 + c;
    if (pp < p.P && q < p.Q) dst[(size_t)pp * p.Q + q] = sC[r * LDC + c];
  }
}

// ---------------------------------------------------------------------------
// 11. out[i] = sum_s part[s][i], in order of s, for every partial at once
// ---------------------------------------------------------------------------

constexpr int SUM_JOBS = 12;
struct SumJob {
  const float* part;
  float* out;
  int S, n;
};
struct SumJobs { SumJob job[SUM_JOBS]; };

__global__ void __launch_bounds__(256) bytenet_bwd_sum_kernel(SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.y];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < jb.n; i += gridDim.x * blockDim.x) {
    float t = 0.f;
    for (int s = 0; s < jb.S; ++s) t += jb.part[(size_t)s * jb.n + i];
    jb.out[i] = t;
  }
}

// ---------------------------------------------------------------------------
// host side: workspace layout and launches
// ---------------------------------------------------------------------------

// rows per split of a weight-gradient GEMM with a P x Q output over M rows
int wgrad_chunk(int M, int P, int Q) {
  const int tiles = ((P + BM - 1) / BM) * ((Q + BN - 1) / BN);
  int splits = (WGRAD_BLOCKS + tiles - 1) / tiles;
  const int most = (M + 255) / 256;  // at least 256 rows a split
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  const int per = (M + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}
int n_splits(int M, int chunk) { return (M + chunk - 1) / chunk; }

struct Layout {
  size_t a, bb, e, de, dq, dbb, dp, da, colpart, w2part, wcpart, w1part, bytes;
  int nblk, c2, cc, c1;  // row blocks; rows per split of dW2, dWc, dW1
};

Layout layout(int B, int L, int D, int H, int K, size_t cd) {
  Layout t;
  const size_t M = (size_t)B * L;
  t.nblk = (int)((M + ROW_BLOCK - 1) / ROW_BLOCK);
  t.c2 = wgrad_chunk((int)M, D, H);
  t.cc = wgrad_chunk((int)M, H, K * H);
  t.c1 = wgrad_chunk((int)M, H, D);
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  t.a = take(M * D * cd);
  t.bb = take(M * H * cd);
  t.e = take(M * H * cd);
  t.de = take(M * H * 4);
  t.dq = take(M * H * cd);
  t.dbb = take(M * H * 4);
  t.dp = take(M * H * cd);
  t.da = take(M * D * 4);
  t.colpart = take((size_t)t.nblk * 3 * (2 * H + D) * 4);
  t.w2part = take((size_t)n_splits((int)M, t.c2) * D * H * 4);
  t.wcpart = take((size_t)n_splits((int)M, t.cc) * H * K * H * 4);
  t.w1part = take((size_t)n_splits((int)M, t.c1) * H * D * 4);
  t.bytes = off;
  return t;
}

template <typename T, int AMODE>
cudaError_t gemm(const GemmArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  bytenet_bwd_gemm_kernel<T, AMODE><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int YMODE>
cudaError_t wgrad(const WgradArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.P + BM - 1) / BM, (a.Q + BN - 1) / BN, n_splits(a.M, a.chunk));
  bytenet_bwd_wgrad_kernel<T, YMODE><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rows(const RowArgs<T>& a, int nblk, cudaStream_t stream) {
  bytenet_bwd_rows_kernel<T><<<nblk, ROW_WARPS * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

struct Grads { float *g1, *b1, *w1, *c1, *g2, *b2, *wc, *cc, *g3, *b3, *w2, *c2; };

template <typename T>
int launch(const T* x, const T* p, const T* q, const float* const* prm, const T* dy, T* dx,
           const Grads& gr, unsigned char* ws, int B, int L, int D, int H, int K, int dil,
           int gelu, cudaStream_t stream, int* launched) {
  // prm: g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2 (f32)
  const int M = B * L;
  const Layout t = layout(B, L, D, H, K, sizeof(T));
  T* a = reinterpret_cast<T*>(ws + t.a);
  T* bb = reinterpret_cast<T*>(ws + t.bb);
  T* e = reinterpret_cast<T*>(ws + t.e);
  float* de = reinterpret_cast<float*>(ws + t.de);
  T* dq = reinterpret_cast<T*>(ws + t.dq);
  float* dbb = reinterpret_cast<float*>(ws + t.dbb);
  T* dp = reinterpret_cast<T*>(ws + t.dp);
  float* da = reinterpret_cast<float*>(ws + t.da);
  float* col3 = reinterpret_cast<float*>(ws + t.colpart);   // [3][nblk][H]
  float* col2 = col3 + (size_t)3 * t.nblk * H;               // [3][nblk][H]
  float* col1 = col2 + (size_t)3 * t.nblk * H;               // [3][nblk][D]
  float* w2p = reinterpret_cast<float*>(ws + t.w2part);
  float* wcp = reinterpret_cast<float*>(ws + t.wcpart);
  float* w1p = reinterpret_cast<float*>(ws + t.w1part);
  cudaError_t err;
#define HD_STEP(call)                                   \
  if ((err = (call)) != cudaSuccess) return (int)err; \
  ++*launched;

  LnJobs<T> jobs{{{x, prm[0], prm[1], a, D}, {p, prm[4], prm[5], bb, H},
                  {q, prm[8], prm[9], e, H}}};
  bytenet_bwd_ln_act_kernel<T><<<dim3((M + LN_ROWS - 1) / LN_ROWS, 3), LN_ROWS * 32, 0,
                                 stream>>>(jobs, M, gelu);
  HD_STEP(cudaGetLastError());
  HD_STEP((gemm<T, A_ROWS>({dy, prm[10], de, M, D, H, 0, 0, 0, 0}, stream)));
  HD_STEP((wgrad<T, Y_ROWS>({dy, e, w2p, M, D, H, t.c2, 0, 0, 0, 0}, stream)));
  HD_STEP(rows<T>({de, q, prm[8], prm[9], nullptr, dq, col3, M, H, gelu}, t.nblk, stream));
  HD_STEP((gemm<T, A_CONVT>({dq, prm[6], dbb, M, K * H, H, L, H, K, dil}, stream)));
  HD_STEP((wgrad<T, Y_CONV>({dq, bb, wcp, M, H, K * H, t.cc, L, H, K, dil}, stream)));
  HD_STEP(rows<T>({dbb, p, prm[4], prm[5], nullptr, dp, col2, M, H, gelu}, t.nblk, stream));
  HD_STEP((gemm<T, A_ROWS>({dp, prm[2], da, M, H, D, 0, 0, 0, 0}, stream)));
  HD_STEP((wgrad<T, Y_ROWS>({dp, a, w1p, M, H, D, t.c1, 0, 0, 0, 0}, stream)));
  HD_STEP(rows<T>({da, x, prm[0], prm[1], dy, dx, col1, M, D, gelu}, t.nblk, stream));

  const size_t nh = (size_t)t.nblk * H, nd = (size_t)t.nblk * D;
  SumJobs sj{{{w2p, gr.w2, n_splits(M, t.c2), D * H},
              {wcp, gr.wc, n_splits(M, t.cc), H * K * H},
              {w1p, gr.w1, n_splits(M, t.c1), H * D},
              {col3, gr.g3, t.nblk, H}, {col3 + nh, gr.b3, t.nblk, H},
              {col3 + 2 * nh, gr.cc, t.nblk, H},
              {col2, gr.g2, t.nblk, H}, {col2 + nh, gr.b2, t.nblk, H},
              {col2 + 2 * nh, gr.c1, t.nblk, H},
              {col1, gr.g1, t.nblk, D}, {col1 + nd, gr.b1, t.nblk, D},
              {col1 + 2 * nd, gr.c2, t.nblk, D}}};
  const int widest = H * K * H > D * H ? H * K * H : D * H;
  bytenet_bwd_sum_kernel<<<dim3((widest + 255) / 256, SUM_JOBS), 256, 0, stream>>>(sj);
  HD_STEP(cudaGetLastError());
#undef HD_STEP
  return 0;
}

bool bad_shape(int B, int L, int D, int H, int K, int dil, int act) {
  return B <= 0 || L <= 0 || D <= 0 || H <= 0 || D % 32 || H % 32 || D > 32 * MAXJ ||
         H > 32 * MAXJ || K <= 0 || K % 2 == 0 || dil <= 0 || (act != 0 && act != 1) ||
         (long long)B * L > (1LL << 30) / D;
}

}  // namespace

// Bytes of workspace hd_bytenet_block_bwd needs (0 for an invalid shape).
extern "C" long long hd_bytenet_block_bwd_workspace(int B, int L, int D, int H, int K,
                                                    int dtype) {
  if (bad_shape(B, L, D, H, K, 1, 0) || (dtype != 0 && dtype != 1)) return 0;
  return (long long)layout(B, L, D, H, K, dtype == 0 ? 4 : 2).bytes;
}

// x, dy, dx [B, L, D] and p, q [B, L, H] in the activation type; params
// g1, b1 [D], w1 [H, D], c1, g2, b2 [H], wc [H, K, H] ([out][tap][in]),
// cc, g3, b3 [H], w2 [D, H], c2 [D], all f32, and their gradients (f32,
// the same shapes, written whole); workspace of
// hd_bytenet_block_bwd_workspace bytes. D and H multiples of 32 up to 1024,
// K odd. dtype 0 = float32, 1 = bfloat16; act 0 = ReLU, 1 = GELU. Sets
// *launched to the number of kernels launched (11 on success) and returns
// a cudaError_t code (0 = all launched).
extern "C" int hd_bytenet_block_bwd(
    const void* x, const void* p, const void* q, const void* g1, const void* b1,
    const void* w1, const void* c1, const void* g2, const void* b2, const void* wc,
    const void* cc, const void* g3, const void* b3, const void* w2, const void* c2,
    const void* dy, void* dx, void* dg1, void* db1, void* dw1, void* dc1, void* dg2,
    void* db2, void* dwc, void* dcc, void* dg3, void* db3, void* dw2, void* dc2,
    void* workspace, int B, int L, int D, int H, int K, int dil, int act, int dtype,
    void* stream, int* launched) {
  *launched = 0;
  if (bad_shape(B, L, D, H, K, dil, act)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto o = [](void* v) { return static_cast<float*>(v); };
  const float* prm[12] = {f(g1), f(b1), f(w1), f(c1), f(g2), f(b2),
                          f(wc), f(cc), f(g3), f(b3), f(w2), f(c2)};
  const Grads gr{o(dg1), o(db1), o(dw1), o(dc1), o(dg2), o(db2),
                 o(dwc), o(dcc), o(dg3), o(db3), o(dw2), o(dc2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<unsigned char*>(workspace);
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(x), static_cast<const float*>(p),
                         static_cast<const float*>(q), prm, static_cast<const float*>(dy),
                         static_cast<float*>(dx), gr, ws, B, L, D, H, K, dil, act, s,
                         launched);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    return launch<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(p),
                        static_cast<const bf16*>(q), prm, static_cast<const bf16*>(dy),
                        static_cast<bf16*>(dx), gr, ws, B, L, D, H, K, dil, act, s,
                        launched);
  }
  return (int)cudaErrorInvalidValue;
}
