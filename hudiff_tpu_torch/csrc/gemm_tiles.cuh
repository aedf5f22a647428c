// The GEMM core shared by the ByteNet kernels: K2 (bytenet_block.cu) and K4
// (bytenet_block_bwd.cu), bf16 and f32 instantiations.
//
// A block of 8 warps accumulates a tile of an [M, N] product over chunks of
// the reduction axis. Chunks arrive by cp.async (16 bytes a thread, zero
// filled outside the operands) into a ring of STAGES slots in shared memory,
// so two chunks are in flight while the tensor cores work on the third. An
// operand policy (`Op`) issues a chunk's copies (rows, the conv's gathered
// rows, the transposed conv's, transposed rows) and may rewrite a landed
// chunk in place before it is read (`Op::TRANSFORM`): K2's first GEMM
// applies LayerNorm 1 + activation to x's rows there.
//
// Products: bf16 runs mma.sync.m16n8k16 (f32 accumulation) on ldmatrix
// fragments (mma_tiles.cuh), with either operand stored row-major or
// transposed in shared memory (ldmatrix.trans). f32 runs fmaf on the same
// accumulator layout, so that the epilogues are written once: a warp's
// accumulator is float acc[MT][NT][4], m-tile i and n-tile j a 16 x 8 tile
// whose thread (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns
// 2t and 2t + 1 ([0], [1] row g; [2], [3] row g + 8). The f32 path is there
// to hold the arithmetic exactly, not to be fast.
//
// A chunk is 128 bytes of each row (64 bf16 or 32 f32), or 64 where a wide
// operand would not fit three slots. Tiles are stored padded or swizzled
// (Pad, Swz) so that ldmatrix reads them without bank conflicts.
#pragma once

#include "mma_tiles.cuh"

namespace hd {
namespace gemm {

using tc::bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;     // cp.async ring slots
constexpr float LN_EPS = 1e-6f;

// elements of a 16-byte vector
template <typename T> constexpr int VEC = 16 / (int)sizeof(T);

template <typename T> struct Pack {
  uint4 u;
  __device__ __forceinline__ T& operator[](int i) { return reinterpret_cast<T*>(&u)[i]; }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// two neighbouring elements of a row, as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// ... and stored, rounded to the element type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack(a, b);
}

__device__ __forceinline__ float act_fn(float u, int gelu) {
  return gelu ? 0.5f * u * (1.f + erff(u * 0.70710678118654752f)) : fmaxf(u, 0.f);
}
// ReLU: u > 0; GELU: exact erf, cdf + u pdf
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

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (mean, 1/sigma) of an f32 LayerNorm from a row's sum and sum of squares
// over n values: the fast variance, clamped at 0, each step rounded as the
// plain version rounds it (no FMA contraction)
__device__ __forceinline__ float2 ln_stats(float s, float s2, int n) {
  const float mean = s / n;
  return make_float2(mean, rsqrtf(fmaxf(__fsub_rn(s2 / n, __fmul_rn(mean, mean)), 0.f) + LN_EPS));
}

// The same from the row itself (n a multiple of 32), one warp
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* row, int n, int lane) {
  constexpr int V = VEC<T>;
  float s = 0.f, s2 = 0.f;
  for (int c = lane * V; c < n; c += 32 * V) {
    Pack<T> p;
    p.u = *reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f(p[e]);
      s += v;
      s2 += v * v;
    }
  }
  return ln_stats(warp_sum(s), warp_sum(s2), n);
}

// The same for R rows at once (one warp; rows[k] null for no row), so that
// the loads of all R rows are in flight together; each row's sums run in
// row_stats's order
template <typename T, int R>
__device__ __forceinline__ void rows_stats(const T* const (&rows)[R], int n, int lane,
                                           float2 (&st)[R]) {
  constexpr int V = VEC<T>;
  float s[R], s2[R];
#pragma unroll
  for (int k = 0; k < R; ++k) s[k] = s2[k] = 0.f;
  for (int c = lane * V; c < n; c += 32 * V) {
    Pack<T> q[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      q[k].u = rows[k] ? *reinterpret_cast<const uint4*>(rows[k] + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = to_f(q[k][e]);
        s[k] += v;
        s2[k] += v * v;
      }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) st[k] = ln_stats(warp_sum(s[k]), warp_sum(s2[k]), n);
}

// The normalised value n = (v - mean) / sigma and the LayerNorm's output
// n g + b, each product and sum rounded on its own, as the plain version's
// separate operations round them
__device__ __forceinline__ float ln_norm(float v, float2 st) {
  return __fmul_rn(v - st.x, st.y);
}
__device__ __forceinline__ float ln_affine(float v, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(ln_norm(v, st), g), b);
}

// A 16-byte vector of a row, channels [ch, ch + V), as cd(act(LN(v))) with
// the row's statistics `st` and the LayerNorm's g, b at the same channels:
// ln_act_pack in registers; ln_act_vec rewrites one in shared memory in
// place, zero when !ok (a row past the rows, a channel past the width).
template <typename T>
__device__ __forceinline__ void ln_act_pack(Pack<T>& q, float2 st, const float* g, const float* b,
                                            int gelu) {
#pragma unroll
  for (int e = 0; e < VEC<T>; e += 4) {
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + e));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + e));
    const float gs[4] = {g4.x, g4.y, g4.z, g4.w}, bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[e + k] = from_f<T>(act_fn(ln_affine(to_f(q[e + k]), st, gs[k], bs[k]), gelu));
  }
}
template <typename T>
__device__ __forceinline__ void ln_act_vec(T* p, float2 st, const float* g, const float* b,
                                           int gelu, bool ok) {
  Pack<T> q;
  q.u = make_uint4(0, 0, 0, 0);
  if (ok) {
    q.u = *reinterpret_cast<const uint4*>(p);
    ln_act_pack(q, st, g, b, gelu);
  }
  *reinterpret_cast<uint4*>(p) = q.u;
}

// Every thread's share of an R x W grid of vectors: f(row, vector)
template <int R, int W, typename F> __device__ __forceinline__ void for_vectors(F&& f) {
  constexpr int N = R * W;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int idx = (int)threadIdx.x + i * THREADS;
    if (N % THREADS == 0 || idx < N) f(idx / W, idx % W);
  }
}

template <int MT, int NT> __device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Tile layouts in shared memory: at(row, col) is the element offset.
// Pad: rows `ld` elements apart (a row's length plus 16 bytes, so the eight
// rows an ldmatrix phase reads start in distinct banks). Swz<W>: rows of
// exactly 128 bytes (W elements, 8 vectors) with vector c of row r stored at
// c ^ (r % 8), which spreads the same eight rows over the banks without
// padding.
struct Pad {
  int ld;
  __device__ __forceinline__ int at(int r, int c) const { return r * ld + c; }
};
template <int W> struct Swz {
  static constexpr int V = W / 8;
  __device__ __forceinline__ int at(int r, int c) const {
    return r * W + ((((c / V) ^ r) & 7) * V) + c % V;
  }
};

// acc += A B over one chunk of depth BK for a warp whose tile starts at row
// wm, column wn. A is sA[m][k] (layout la) or, when AK, sA[k][m]; B is
// sB[n][k] (lb) or, when BK_MAJOR, sB[k][n].
template <typename T> struct Mma;

template <> struct Mma<bf16> {
  template <int MT, int NT, int BK, bool AK, bool BK_MAJOR, typename LA, typename LB>
  static __device__ __forceinline__ void run(float (&acc)[MT][NT][4], const bf16* sA, LA la,
                                             const bf16* sB, LB lb, int wm, int wn, int lane) {
    static_assert(NT % 2 == 0 && BK % 16 == 0, "n-tiles come in pairs, k in steps of 16");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (AK)  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), ...
          tc::ldsm_x4_trans(a[i], sA + la.at(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                             wm + 16 * i + ((lane >> 3) & 1) * 8));
        else
          tc::ldsm_x4(a[i], sA + la.at(wm + 16 * i + (lane & 15), ks * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        if constexpr (BK_MAJOR)
          tc::ldsm_x4_trans(b, sB + lb.at(ks * 16 + (lane & 15), wn + 16 * jp + (lane >> 4) * 8));
        else
          tc::ldsm_x4(b, sB + lb.at(wn + 16 * jp + (lane & 7) + ((lane >> 4) << 3),
                                    ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tc::mma(acc[i][2 * jp], a[i], b[0], b[1]);
          tc::mma(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
};

template <> struct Mma<float> {
  template <int MT, int NT, int BK, bool AK, bool BK_MAJOR, typename LA, typename LB>
  static __device__ __forceinline__ void run(float (&acc)[MT][NT][4], const float* sA, LA la,
                                             const float* sB, LB lb, int wm, int wn, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      float a[MT][2], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm + 16 * i + g + 8 * h;
          a[i][h] = sA[AK ? la.at(k, m) : la.at(m, k)];
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn + 8 * j + 2 * t + e;
          b[j][e] = sB[BK_MAJOR ? lb.at(k, n) : lb.at(n, k)];
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[i][j][0] = fmaf(a[i][0], b[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(a[i][0], b[j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(a[i][1], b[j][0], acc[i][j][2]);
          acc[i][j][3] = fmaf(a[i][1], b[j][1], acc[i][j][3]);
        }
    }
  }
};

// The pipelined mainloop over `nchunks` chunks: chunk c sits in slot
// c % STAGES (sA + slot * a_slot, sB + slot * b_slot). op.issue(c, slot)
// issues chunk c's copies (no commit), for c = 0, 1, 2, ... in order, so a
// policy may count chunks instead of dividing; when Op::TRANSFORM,
// op.transform(c, slot) rewrites the landed chunk before it is read. Every
// thread of the block takes part; on return the ring is drained and free.
template <typename T, int MT, int NT, int BK, bool AK, bool BK_MAJOR, typename Op, typename LA,
          typename LB>
__device__ __forceinline__ void mainloop(float (&acc)[MT][NT][4], Op& op, int nchunks,
                                         const T* sA, int a_slot, LA la, const T* sB,
                                         int b_slot, LB lb, int wm, int wn, int lane) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) op.issue(s, s);
    tc::cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();              // ... every thread's, and slot (c - 1) is read
    const int slot = c % STAGES;
    const int next = c + STAGES - 1;  // into slot (c - 1): in flight during the rest
    if (next < nchunks) op.issue(next, next % STAGES);
    tc::cp_async_commit();
    if constexpr (Op::TRANSFORM) {
      op.transform(c, slot);
      __syncthreads();
    }
    Mma<T>::template run<MT, NT, BK, AK, BK_MAJOR>(acc, sA + slot * a_slot, la,
                                                   sB + slot * b_slot, lb, wm, wn, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The largest dynamic shared memory a block may ask for on this device;
// set once per kernel instantiation, since the port drives one card per
// process
inline int smem_optin() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  return bytes;
}

}  // namespace gemm
}  // namespace hd
