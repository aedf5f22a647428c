// K1: fused rotate-half RoPE + softmax attention over a head-major merged
// qkv projection, forward only.
//
// Replaces hudiff_tpu/ops/pallas_attention.py::_rope_fwd_kernel_qkv (called
// through _pallas_fwd_qkv / rope_attention_qkv).
//
// What it computes, per batch row b and head h (D = 64):
//   q, k = rope(qkv[b, :, h*3D + {0, D}])        rotate-half, in f32
//   S    = (q k^T in the input type, f32 accumulation) * scale
//   P    = softmax(S) over all L keys (no mask: the pad token is a token)
//   out[b, :, h*D:(h+1)*D] = P v                  f32 accumulation
//
// What bounds it on an H100: bytes. At B=64, L=291, bf16 one call reads the
// 57 MB qkv block and writes 19 MB, about 23 us at 3.35 TB/s, against about
// 11 GFLOP (11 us) of tensor-core work.
//
// Design: the TPU kernel held one batch row's whole [L, L] score block in
// VMEM. An f32 [291, 291] block is 339 KB, more than a block's 227 KB of
// shared memory, so here one block takes (b, h, 64 queries) and walks the
// keys in tiles of 64 with an online softmax (running max and sum per row;
// the output accumulator is rescaled in shared memory). Keys >= L are
// masked to -inf and rows >= L are never stored, so any L works. Tiles are
// read with 16-byte loads, and the next key/value tile's loads are issued
// into registers before the current tile is computed, so their latency
// overlaps the tensor-core work. In the softmax each lane owns two columns
// of every row (no shared-memory bank conflicts). bf16 products run on WMMA
// 16x16x16 fragments with f32 accumulators; f32 inputs (the tests'
// reference type) take a plain FMA path so they stay exact. Each query tile
// reads its head's K/V again; the repeats hit L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int HD = 64;       // head dim
constexpr int D2 = HD / 2;
constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile
constexpr int WARPS = 4;     // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDF = 64 + 4;  // f32 tile row stride (WMMA: multiple of 4)

template <typename T> struct Cfg { static constexpr int PAD = 4, VEC = 4; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8, VEC = 8; };

// 16 bytes of T
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

template <typename T>
struct Smem {
  static constexpr int LDT = HD + Cfg<T>::PAD;   // q/k/v tile row stride
  static constexpr int LDP = BKV + Cfg<T>::PAD;  // probability tile row stride
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + BQ * LDT * (int)sizeof(T), 128);
  static constexpr int V = round_up(K + BKV * LDT * (int)sizeof(T), 128);
  static constexpr int P = round_up(V + BKV * LDT * (int)sizeof(T), 128);
  static constexpr int S = round_up(P + BQ * LDP * (int)sizeof(T), 128);
  static constexpr int O = round_up(S + BQ * LDF * 4, 128);
  static constexpr int BYTES = round_up(O + BQ * LDF * 4, 128);
};

// One 64-row tile of q or k (rotated) and v, held in registers between the
// global loads and the shared-memory stores. Rotated item: one row's
// columns [c, c + V) and [c + 32, c + 32 + V) with their cos/sin.
template <typename T> struct TileRegs {
  static constexpr int V = Cfg<T>::VEC;
  static constexpr int NR = 64 * (D2 / V) / THREADS;  // rotated items per thread
  static constexpr int NV = 64 * (HD / V) / THREADS;  // plain vectors per thread
  Pack<T> x0[NR], x1[NR], v[NV];
  float cs[NR][V], sn[NR][V];

  // rows [row0, row0 + 64) of one batch row; `col` is the q or k column
  // group, `vcol` the v group (< 0: no v)
  __device__ void load(const T* qkv, const float* cos_t, const float* sin_t, int b,
                       int row0, int L, int col, int vcol, int row_stride) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V, l = row0 + r;
      x0[i].u = x1[i].u = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < V; ++e) cs[i][e] = sn[i][e] = 0.f;
      if (l < L) {
        const T* src = qkv + ((size_t)b * L + l) * row_stride + col + c0;
        x0[i].u = *reinterpret_cast<const uint4*>(src);
        x1[i].u = *reinterpret_cast<const uint4*>(src + D2);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 cc = *reinterpret_cast<const float4*>(cos_t + l * D2 + c0 + e);
          const float4 ss = *reinterpret_cast<const float4*>(sin_t + l * D2 + c0 + e);
          cs[i][e] = cc.x, cs[i][e + 1] = cc.y, cs[i][e + 2] = cc.z, cs[i][e + 3] = cc.w;
          sn[i][e] = ss.x, sn[i][e + 1] = ss.y, sn[i][e + 2] = ss.z, sn[i][e + 3] = ss.w;
        }
      }
    }
    if (vcol < 0) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V, l = row0 + r;
      v[i].u = make_uint4(0, 0, 0, 0);
      if (l < L)
        v[i].u = *reinterpret_cast<const uint4*>(qkv + ((size_t)b * L + l) * row_stride +
                                                  vcol + c0);
    }
  }

  // rotate in f32 and round to T: (a, b) -> (a cos - b sin, a sin + b cos)
  __device__ void store(T* s_rot, T* s_v) {
    constexpr int LDT = Smem<T>::LDT;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V;
      Pack<T> lo, hi;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float x = to_f(x0[i][e]), y = to_f(x1[i][e]);
        lo[e] = from_f<T>(x * cs[i][e] - y * sn[i][e]);
        hi[e] = from_f<T>(x * sn[i][e] + y * cs[i][e]);
      }
      *reinterpret_cast<uint4*>(s_rot + r * LDT + c0) = lo.u;
      *reinterpret_cast<uint4*>(s_rot + r * LDT + c0 + D2) = hi.u;
    }
    if (s_v == nullptr) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V;
      *reinterpret_cast<uint4*>(s_v + r * LDT + c0) = v[i].u;
    }
  }
};

// S[16 rows of this warp][64 keys] = Q K^T (unscaled), into sS.
template <typename T>
__device__ void scores(const T* sQ, const T* sK, float* sS, int warp, int lane) {
  constexpr int LDT = Smem<T>::LDT;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sQ + warp * 16 * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        // B[d][key] = K[key][d]: column-major view of the K tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sK + j * 16 * LDT + kk, LDT);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j)
      wmma::store_matrix_sync(sS + warp * 16 * LDF + j * 16, acc[j], LDF,
                              wmma::mem_row_major);
  } else {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
    const float* q = sQ + r * LDT;
    for (int c = c0; c < c0 + 32; ++c) {
      const float* k = sK + c * LDT;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], k[d], s);
      sS[r * LDF + c] = s;
    }
  }
}

// O[16 rows][64] += P[16 rows][64 keys] V[64 keys][64], O kept in sO.
template <typename T>
__device__ void accumulate_pv(const T* sP, const T* sV, float* sO, int warp, int lane) {
  constexpr int LDT = Smem<T>::LDT;
  constexpr int LDP = Smem<T>::LDP;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::load_matrix_sync(acc[j], sO + warp * 16 * LDF + j * 16, LDF, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sP + warp * 16 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sV + kk * LDT + j * 16, LDT);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::store_matrix_sync(sO + warp * 16 * LDF + j * 16, acc[j], LDF, wmma::mem_row_major);
  } else {
    const int r = warp * 16 + (lane >> 1), d0 = (lane & 1) * 32;
    float o[32];
#pragma unroll
    for (int d = 0; d < 32; ++d) o[d] = sO[r * LDF + d0 + d];
    for (int c = 0; c < BKV; ++c) {
      const float p = sP[r * LDP + c];
      const float* v = sV + c * LDT + d0;
#pragma unroll
      for (int d = 0; d < 32; ++d) o[d] = fmaf(p, v[d], o[d]);
    }
#pragma unroll
    for (int d = 0; d < 32; ++d) sO[r * LDF + d0 + d] = o[d];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rope_attention_qkv_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, T* __restrict__ out, int L, int H,
                          float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  T* sQ = reinterpret_cast<T*>(smem + SM::Q);
  T* sK = reinterpret_cast<T*>(smem + SM::K);
  T* sV = reinterpret_cast<T*>(smem + SM::V);
  T* sP = reinterpret_cast<T*>(smem + SM::P);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sO = reinterpret_cast<float*>(smem + SM::O);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_stride = 3 * H * HD, qcol = h * 3 * HD;

  TileRegs<T> regs;
  regs.load(qkv, cos_t, sin_t, b, q0, L, qcol, -1, row_stride);
  regs.store(sQ, nullptr);
  regs.load(qkv, cos_t, sin_t, b, 0, L, qcol + HD, qcol + 2 * HD, row_stride);
  for (int idx = threadIdx.x; idx < BQ * LDF; idx += THREADS) sO[idx] = 0.f;

  // every lane of a warp tracks the running max / sum of the warp's 16 rows
  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BKV) {
    __syncthreads();  // previous tile's sK / sV fully read
    regs.store(sK, sV);
    __syncthreads();
    if (k0 + BKV < L)  // next tile's loads overlap this tile's compute
      regs.load(qkv, cos_t, sin_t, b, k0 + BKV, L, qcol + HD, qcol + 2 * HD, row_stride);

    scores<T>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // online softmax; lane owns columns lane and lane + 32 of each row
    const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float s0 = ok0 ? sS[row * LDF + lane] * scale : -INFINITY;
      const float s1 = ok1 ? sS[row * LDF + lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run[r] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      m_run[r] = m_new;
      sP[row * SM::LDP + lane] = from_f<T>(p0);
      sP[row * SM::LDP + lane + 32] = from_f<T>(p1);
      sO[row * LDF + lane] *= alpha;
      sO[row * LDF + lane + 32] *= alpha;
    }
    __syncwarp();
    accumulate_pv<T>(sP, sV, sO, warp, lane);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, l = q0 + row;
    if (l < L) {
      const float inv = 1.f / l_run[r];
      T* dst = out + ((size_t)b * L + l) * (H * HD) + h * HD;
      dst[lane] = from_f<T>(sO[row * LDF + lane] * inv);
      dst[lane + 32] = from_f<T>(sO[row * LDF + lane + 32] * inv);
    }
  }
}

template <typename T>
int launch(const void* qkv, const float* cos_t, const float* sin_t, void* out, int B, int L,
           int H, float scale, cudaStream_t stream) {
  auto kernel = rope_attention_qkv_kernel<T>;
  // set once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, Smem<T>::BYTES, stream>>>(
      static_cast<const T*>(qkv), cos_t, sin_t, static_cast<T*>(out), L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, out [B, L, H*64];
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int hd_rope_attention_qkv(const void* qkv, const void* cos_t, const void* sin_t,
                                     void* out, int B, int L, int H, int head_dim,
                                     float scale, int dtype, void* stream) {
  if (head_dim != HD || B <= 0 || L <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cos_t);
  auto n = static_cast<const float*>(sin_t);
  if (dtype == 0) return launch<float>(qkv, c, n, out, B, L, H, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, c, n, out, B, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
