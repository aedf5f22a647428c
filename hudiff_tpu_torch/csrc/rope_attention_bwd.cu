// K3: backward of the fused rotate-half RoPE attention over a head-major
// merged qkv projection (K1), as two launches.
//
// Replaces hudiff_tpu/ops/pallas_attention.py::_rope_bwd_kernel_qkv (called
// through _pallas_bwd_qkv, the backward of the custom VJP around K1).
//
// What it computes, per batch row b and head h (D = 64), with T the input
// type (f32 or bf16) and every product of T values accumulated in f32:
//   qh, kh = T(rope(q)), T(rope(k))            rotate-half, in f32
//   P      = softmax(qh kh^T * scale)           f32, over all L keys
//   dv     = T(P)^T dO
//   dP     = dO v^T ; delta = rowsum(dP o P)
//   dS     = T(P o (dP - delta))
//   dq     = rope^T(dS kh * scale), dk = rope^T(dS^T qh * scale), in f32
//   dqkv[b, :, h*3D + {0, D, 2D}] = T(dq), T(dk), T(dv)
//
// What bounds it on an H100: at B=128, L=291, bf16 one call reads qkv and
// dO (143 MB) and writes dqkv (114 MB), 0.080 ms at 3.35 TB/s, against five
// 2*L^2*D products per (row, head), 55.5 GFLOP or 0.056 ms at 989 TFLOP/s:
// bytes, narrowly.
//
// Design: the TPU kernel held a row's whole [L, L] score block per head in
// VMEM; an f32 [291, 291] block is 339 KB, more than a block's 227 KB of
// shared memory, and dK, dV are sums over all query rows, which Hopper
// blocks cannot carry across a grid. So two passes, with no atomics and the
// same bits every run:
//   (a) rope_attention_bwd_dq_kernel: one block per (b, h, 64 queries)
//       walks the keys in 64-wide tiles twice. The first walk keeps the
//       running max m, sum l and sum of exp(s - m) * dP per row (online, as
//       K1 does), so delta = that sum / l; the second recomputes P exactly,
//       forms dS and accumulates dQ = dS K. It writes dq and the row
//       statistics (m, l, delta) [3][B, H, L] f32.
//   (b) rope_attention_bwd_dkv_kernel: one block per (b, h, 64 keys) walks
//       the query tiles, recomputes P from the saved statistics and
//       accumulates dV = P^T dO and dK = dS^T Q in registers.
// Keys >= L are masked, rows >= L never written. bf16 products run on WMMA
// 16x16x16 fragments with f32 accumulators (the transposed products load a
// column-major A fragment); f32 inputs take a plain FMA path so they stay
// exact. Tiles are staged synchronously; each pass recomputes S (and dP)
// instead of keeping them, so the block's shared memory stays at 91 KB in
// bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

using namespace nvcuda;

namespace {

constexpr int HD = 64;       // head dim
constexpr int D2 = HD / 2;
constexpr int BT = 64;       // queries or keys per tile
constexpr int WARPS = 4;     // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int LDF = 64 + 4;  // f32 tile row stride (WMMA: multiple of 4)

template <typename T> struct Cfg { static constexpr int PAD = 4, VEC = 4; };
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory: six T tiles [64][LDT] and two f32 tiles [64][LDF], plus
// three per-row statistics of a query tile.
template <typename T> struct Smem {
  static constexpr int LDT = HD + Cfg<T>::PAD;
  static constexpr int TILE = round_up(BT * LDT * (int)sizeof(T), 128);
  static constexpr int FTILE = round_up(BT * LDF * 4, 128);
  static constexpr int T0 = 0;                       // 6 T tiles
  static constexpr int F0 = 6 * TILE;                // 2 f32 tiles
  static constexpr int ST = F0 + 2 * FTILE;          // 3 x 64 f32
  static constexpr int BYTES = ST + 3 * BT * 4;
};

// rows [row0, row0 + 64) of q or k (column group `col`), rotated in f32 and
// rounded to T; zero rows past L
template <typename T>
__device__ void load_rot(T* dst, const T* src, const float* cos_t, const float* sin_t,
                         int b, int row0, int L, int col, int row_stride) {
  constexpr int V = Cfg<T>::VEC, LDT = Smem<T>::LDT;
  for (int idx = threadIdx.x; idx < BT * (D2 / V); idx += THREADS) {
    const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V, l = row0 + r;
    Pack<T> lo, hi;
    lo.u = hi.u = make_uint4(0, 0, 0, 0);
    if (l < L) {
      const T* p = src + ((size_t)b * L + l) * row_stride + col + c0;
      Pack<T> x0, x1;
      x0.u = *reinterpret_cast<const uint4*>(p);
      x1.u = *reinterpret_cast<const uint4*>(p + D2);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = cos_t[l * D2 + c0 + e], s = sin_t[l * D2 + c0 + e];
        const float x = to_f(x0[e]), y = to_f(x1[e]);
        lo[e] = from_f<T>(x * c - y * s);
        hi[e] = from_f<T>(x * s + y * c);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c0) = lo.u;
    *reinterpret_cast<uint4*>(dst + r * LDT + c0 + D2) = hi.u;
  }
}

// rows [row0, row0 + 64) of a 64-wide column group as they are
template <typename T>
__device__ void load_plain(T* dst, const T* src, int b, int row0, int L, int col,
                           int row_stride) {
  constexpr int V = Cfg<T>::VEC, LDT = Smem<T>::LDT;
  for (int idx = threadIdx.x; idx < BT * (HD / V); idx += THREADS) {
    const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V, l = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (l < L)
      v = *reinterpret_cast<const uint4*>(src + ((size_t)b * L + l) * row_stride + col + c0);
    *reinterpret_cast<uint4*>(dst + r * LDT + c0) = v;
  }
}

// A warp's 16 x 64 f32 accumulator over rows [16 warp, 16 warp + 16) of C.
// Every operand is a 64 x 64 T tile with row stride LDT; depth 64.
//   abt: C += A B^T     ab: C += A B     atb: C += A^T B
template <typename T> struct Acc;

template <> struct Acc<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int LD = Smem<bf16>::LDT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(f[j], 0.f);
  }
  __device__ void abt(const bf16* A, const bf16* B, int warp, int) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + warp * 16 * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + j * 16 * LD + kk, LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ void ab(const bf16* A, const bf16* B, int warp, int) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + warp * 16 * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * LD + j * 16, LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ void atb(const bf16* A, const bf16* B, int warp, int) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      // A^T[m][k] = A[k][m]: a column-major view of A's rows kk..kk+15
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, A + kk * LD + warp * 16, LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * LD + j * 16, LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ void store(float* C, int warp, int) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(C + warp * 16 * LDF + j * 16, f[j], LDF, wmma::mem_row_major);
  }
};

// f32: lane owns row 16 warp + lane / 2, columns [32 (lane & 1), +32).
template <> struct Acc<float> {
  static constexpr int LD = Smem<float>::LDT;
  float c[32];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 32; ++j) c[j] = 0.f;
  }
  __device__ void abt(const float* A, const float* B, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    for (int d = 0; d < 64; ++d) {
      const float a = A[r * LD + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) c[j] = fmaf(a, B[(c0 + j) * LD + d], c[j]);
    }
  }
  __device__ void ab(const float* A, const float* B, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    for (int k = 0; k < 64; ++k) {
      const float a = A[r * LD + k];
#pragma unroll
      for (int j = 0; j < 32; ++j) c[j] = fmaf(a, B[k * LD + c0 + j], c[j]);
    }
  }
  __device__ void atb(const float* A, const float* B, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    for (int k = 0; k < 64; ++k) {
      const float a = A[k * LD + r];
#pragma unroll
      for (int j = 0; j < 32; ++j) c[j] = fmaf(a, B[k * LD + c0 + j], c[j]);
    }
  }
  __device__ void store(float* C, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) C[r * LDF + c0 + j] = c[j];
  }
};

// One output row's 64 columns from an f32 tile row: rotated back by the
// inverse RoPE after scaling (rot = true), or as they are.
template <typename T>
__device__ void write_row(T* dst, const float* row, const float* cos_t, const float* sin_t,
                          int l, float scale, bool rot, int lane) {
  if (rot) {
    const float a = row[lane] * scale, b = row[lane + D2] * scale;
    const float c = cos_t[l * D2 + lane], s = sin_t[l * D2 + lane];
    dst[lane] = from_f<T>(a * c + b * s);
    dst[lane + D2] = from_f<T>(b * c - a * s);
  } else {
    dst[lane] = from_f<T>(row[lane]);
    dst[lane + D2] = from_f<T>(row[lane + D2]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rope_attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, const T* __restrict__ dout,
                             T* __restrict__ dqkv, float* __restrict__ stats, int L, int H,
                             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  constexpr int LDT = SM::LDT;
  T* sQ = reinterpret_cast<T*>(smem + 0 * SM::TILE);
  T* sDO = reinterpret_cast<T*>(smem + 1 * SM::TILE);
  T* sK = reinterpret_cast<T*>(smem + 2 * SM::TILE);
  T* sV = reinterpret_cast<T*>(smem + 3 * SM::TILE);
  T* sDS = reinterpret_cast<T*>(smem + 4 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_stride = 3 * H * HD, qcol = h * 3 * HD;
  const int o_stride = H * HD, ocol = h * HD;
  const size_t bhl = (size_t)gridDim.z * H * L, srow = ((size_t)b * H + h) * L;

  load_rot(sQ, qkv, cos_t, sin_t, b, q0, L, qcol, row_stride);
  load_plain(sDO, dout, b, q0, L, ocol, o_stride);

  // every lane of a warp tracks its 16 rows' running max, sum and
  // sum of exp(s - m) * dP
  float m_run[16], l_run[16], d_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f, d_run[r] = 0.f;

  Acc<T> acc;
  for (int pass = 0; pass < 2; ++pass) {
    Acc<T> dq;
    dq.zero();
    for (int k0 = 0; k0 < L; k0 += BT) {
      __syncthreads();  // previous tile fully read
      load_rot(sK, qkv, cos_t, sin_t, b, k0, L, qcol + HD, row_stride);
      load_plain(sV, qkv, b, k0, L, qcol + 2 * HD, row_stride);
      __syncthreads();
      acc.zero();
      acc.abt(sQ, sK, warp, lane);
      acc.store(sS, warp, lane);
      acc.zero();
      acc.abt(sDO, sV, warp, lane);
      acc.store(sDP, warp, lane);
      __syncwarp();
      const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r;
        const float s0 = ok0 ? sS[row * LDF + lane] * scale : -INFINITY;
        const float s1 = ok1 ? sS[row * LDF + lane + 32] * scale : -INFINITY;
        const float dp0 = sDP[row * LDF + lane], dp1 = sDP[row * LDF + lane + 32];
        if (pass == 0) {
          const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
          const float alpha = expf(m_run[r] - m_new);
          const float e0 = ok0 ? expf(s0 - m_new) : 0.f;
          const float e1 = ok1 ? expf(s1 - m_new) : 0.f;
          l_run[r] = l_run[r] * alpha + warp_sum(e0 + e1);
          d_run[r] = d_run[r] * alpha + warp_sum(e0 * dp0 + e1 * dp1);
          m_run[r] = m_new;
        } else {
          const float p0 = ok0 ? expf(s0 - m_run[r]) / l_run[r] : 0.f;
          const float p1 = ok1 ? expf(s1 - m_run[r]) / l_run[r] : 0.f;
          sDS[row * LDT + lane] = from_f<T>(p0 * (dp0 - d_run[r]));
          sDS[row * LDT + lane + 32] = from_f<T>(p1 * (dp1 - d_run[r]));
        }
      }
      __syncwarp();
      if (pass == 1) dq.ab(sDS, sK, warp, lane);  // the warp's own dS rows, every key
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        d_run[r] /= l_run[r];  // delta = rowsum(dP o P)
        const int l = q0 + warp * 16 + r;
        if (lane == 0 && l < L) {
          stats[srow + l] = m_run[r];
          stats[bhl + srow + l] = l_run[r];
          stats[2 * bhl + srow + l] = d_run[r];
        }
      }
    } else {
      __syncwarp();
      dq.store(sS, warp, lane);  // the warp's own rows of sS
      __syncwarp();
#pragma unroll 1
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r, l = q0 + row;
        if (l < L)
          write_row(dqkv + ((size_t)b * L + l) * row_stride + qcol, sS + row * LDF, cos_t,
                    sin_t, l, scale, true, lane);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rope_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, const T* __restrict__ dout,
                              T* __restrict__ dqkv, const float* __restrict__ stats, int L,
                              int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  constexpr int LDT = SM::LDT;
  T* sK = reinterpret_cast<T*>(smem + 0 * SM::TILE);
  T* sV = reinterpret_cast<T*>(smem + 1 * SM::TILE);
  T* sQ = reinterpret_cast<T*>(smem + 2 * SM::TILE);
  T* sDO = reinterpret_cast<T*>(smem + 3 * SM::TILE);
  T* sP = reinterpret_cast<T*>(smem + 4 * SM::TILE);
  T* sDS = reinterpret_cast<T*>(smem + 5 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);
  float* sM = reinterpret_cast<float*>(smem + SM::ST);
  float* sL = sM + BT;
  float* sD = sL + BT;

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_stride = 3 * H * HD, qcol = h * 3 * HD;
  const int o_stride = H * HD, ocol = h * HD;
  const size_t bhl = (size_t)gridDim.z * H * L, srow = ((size_t)b * H + h) * L;

  load_rot(sK, qkv, cos_t, sin_t, b, k0, L, qcol + HD, row_stride);
  load_plain(sV, qkv, b, k0, L, qcol + 2 * HD, row_stride);

  Acc<T> dk, dv, acc;
  dk.zero();
  dv.zero();
  const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // previous query tile fully read
    load_rot(sQ, qkv, cos_t, sin_t, b, q0, L, qcol, row_stride);
    load_plain(sDO, dout, b, q0, L, ocol, o_stride);
    for (int i = threadIdx.x; i < BT; i += THREADS) {
      const bool ok = q0 + i < L;
      sM[i] = ok ? stats[srow + q0 + i] : 0.f;
      sL[i] = ok ? stats[bhl + srow + q0 + i] : 1.f;
      sD[i] = ok ? stats[2 * bhl + srow + q0 + i] : 0.f;
    }
    __syncthreads();
    acc.zero();
    acc.abt(sQ, sK, warp, lane);  // S[query][key]
    acc.store(sS, warp, lane);
    acc.zero();
    acc.abt(sDO, sV, warp, lane);  // dP[query][key]
    acc.store(sDP, warp, lane);
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const bool okq = q0 + row < L;
      const float m = sM[row], l = sL[row], delta = sD[row];
      const float p0 = okq && ok0 ? expf(sS[row * LDF + lane] * scale - m) / l : 0.f;
      const float p1 = okq && ok1 ? expf(sS[row * LDF + lane + 32] * scale - m) / l : 0.f;
      sP[row * LDT + lane] = from_f<T>(p0);
      sP[row * LDT + lane + 32] = from_f<T>(p1);
      sDS[row * LDT + lane] = from_f<T>(p0 * (sDP[row * LDF + lane] - delta));
      sDS[row * LDT + lane + 32] = from_f<T>(p1 * (sDP[row * LDF + lane + 32] - delta));
    }
    __syncthreads();  // the products below read every query row
    dv.atb(sP, sDO, warp, lane);   // dV[key][d] += sum_q P[q][key] dO[q][d]
    dk.atb(sDS, sQ, warp, lane);   // dK[key][d] += sum_q dS[q][key] Q[q][d]
  }
  __syncthreads();
  dv.store(sS, warp, lane);
  dk.store(sDP, warp, lane);
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, l = k0 + row;
    if (l < L) {
      T* dst = dqkv + ((size_t)b * L + l) * row_stride + qcol;
      write_row(dst + HD, sDP + row * LDF, cos_t, sin_t, l, scale, true, lane);
      write_row(dst + 2 * HD, sS + row * LDF, cos_t, sin_t, l, scale, false, lane);
    }
  }
}

template <typename T>
int launch(const void* qkv, const float* cos_t, const float* sin_t, const void* dout,
           void* dqkv, float* stats, int B, int L, int H, float scale, cudaStream_t stream,
           int* launched) {
  constexpr int bytes = Smem<T>::BYTES;
  // set once per instantiation: the port drives one card per process
  static const cudaError_t a1 = cudaFuncSetAttribute(
      rope_attention_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      rope_attention_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const dim3 grid((L + BT - 1) / BT, H, B);
  auto q = static_cast<const T*>(qkv);
  auto d = static_cast<const T*>(dout);
  auto g = static_cast<T*>(dqkv);
  cudaError_t err;
  rope_attention_bwd_dq_kernel<T><<<grid, THREADS, bytes, stream>>>(q, cos_t, sin_t, d, g,
                                                                     stats, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  rope_attention_bwd_dkv_kernel<T><<<grid, THREADS, bytes, stream>>>(q, cos_t, sin_t, d, g,
                                                                      stats, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // namespace

// qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, dout [B, L, H*64] in
// qkv's type, dqkv [B, L, H*3*64] out, stats [3, B, H, L] f32 scratch;
// dtype 0 = float32, 1 = bfloat16. Sets *launched to the number of kernels
// launched (2 on success) and returns a cudaError_t code (0 = launched).
extern "C" int hd_rope_attention_qkv_bwd(const void* qkv, const void* cos_t,
                                         const void* sin_t, const void* dout, void* dqkv,
                                         void* stats, int B, int L, int H, int head_dim,
                                         float scale, int dtype, void* stream, int* launched) {
  *launched = 0;
  if (head_dim != HD || B <= 0 || L <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cos_t);
  auto n = static_cast<const float*>(sin_t);
  auto st = static_cast<float*>(stats);
  if (dtype == 0) return launch<float>(qkv, c, n, dout, dqkv, st, B, L, H, scale, s, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, c, n, dout, dqkv, st, B, L, H, scale, s, launched);
  return (int)cudaErrorInvalidValue;
}
