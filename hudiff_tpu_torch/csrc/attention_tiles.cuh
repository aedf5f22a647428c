// Device helpers shared by the attention kernels: rope_attention.cu (K1, K5,
// K7), rope_attention_bwd.cu (K3, K6) and fused_layer.cu (K8).
//
// Every tile is 64 rows of a 64-wide head; a block has four warps and each
// warp owns 16 rows of a tile. The accumulator tile (Acc) and the shared-
// memory softmax serve the f32 paths (the tests' reference type: plain FMA,
// so products stay exact); the bf16 paths run on mma_tiles.cuh and
// wgmma_tiles.cuh. T tiles have row stride LDT; f32 tiles LDF.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace hd {

constexpr int HD = 64;       // head dim
constexpr int D2 = HD / 2;
constexpr int WARPS = 4;     // each warp owns 16 rows of a 64-row tile
constexpr int THREADS = WARPS * 32;
constexpr int LDF = 64 + 4;  // f32 tile row stride
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

template <typename T> struct Cfg { static constexpr int PAD = 4, VEC = 4; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8, VEC = 8; };

// row stride of a 64-wide T tile
template <typename T> __host__ __device__ constexpr int ldt() { return HD + Cfg<T>::PAD; }

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

// Where a [.., L, .., 64] operand's head slice lies: element (b, h, l, c) at
// b * batch + h * head + l * row + c (in elements).
struct Layout {
  int batch, row, head;
  __device__ __forceinline__ size_t at(int b, int h) const {
    return (size_t)b * batch + (size_t)h * head;
  }
};

// A warp's 16 x 64 f32 accumulator over rows [16 warp, 16 warp + 16) of C.
// Every operand is a 64 x 64 T tile with row stride LDT; depth 64.
//   abt: C += A B^T     ab: C += A B     atb: C += A^T B
template <typename T> struct Acc;

// f32: lane owns row 16 warp + lane / 2, columns [32 (lane & 1), +32); every
// sum runs over the depth in order.
template <> struct Acc<float> {
  static constexpr int LD = ldt<float>();
  float c[32];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 32; ++j) c[j] = 0.f;
  }
  __device__ void load(const float* C, int warp, int lane) {
    const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) c[j] = C[r * LDF + c0 + j];
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

// One 64-key tile of the online softmax over a warp's 16 query rows. sS
// holds the unscaled scores (keys k0 + [0, 64)); keys >= L are masked. Updates
// the running max and sum, writes P (rounded to T) into sP and rescales the
// output accumulator rows of sO. Lane owns columns lane and lane + 32.
template <typename T>
__device__ __forceinline__ void softmax_tile(const float* sS, T* sP, float* sO,
                                             float (&m_run)[16], float (&l_run)[16], int k0,
                                             int L, float scale, int warp, int lane) {
  constexpr int LDP = ldt<T>();
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
    sP[row * LDP + lane] = from_f<T>(p0);
    sP[row * LDP + lane + 32] = from_f<T>(p1);
    sO[row * LDF + lane] *= alpha;
    sO[row * LDF + lane + 32] *= alpha;
  }
}

// The warp's 16 rows of sO divided by their sums, rounded to T, into
// dst + l * row_stride for l = q0 + row < L.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, int row_stride, const float* sO,
                                           const float (&l_run)[16], int q0, int L, int warp,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, l = q0 + row;
    if (l < L) {
      const float inv = 1.f / l_run[r];
      T* d = dst + (size_t)l * row_stride;
      d[lane] = from_f<T>(sO[row * LDF + lane] * inv);
      d[lane + 32] = from_f<T>(sO[row * LDF + lane + 32] * inv);
    }
  }
}

}  // namespace hd
