// Register-resident bf16 tiles for the attention kernels on Hopper's
// mma.sync path: rope_attention.cu (K1, K5, K7), rope_attention_bwd.cu
// (K3, K6) and fused_layer.cu's attention (K8), bf16 instantiations.
//
// A block of four warps works on 64-row tiles of a 64-wide head; each warp
// owns 16 rows. Tiles of T = bf16 sit in shared memory with row stride
// LD = 72 elements (144 bytes): the eight rows an ldmatrix phase reads start
// 4 banks apart, so the reads are free of bank conflicts. They arrive with
// cp.async (16 bytes a thread, rows past L zero-filled).
//
// Products are mma.sync.m16n8k16 (bf16 in, f32 accumulation). A warp's
// 16 x 64 f32 accumulator is float c[8][4]: n-tile j holds columns
// [8j, 8j + 8); with g = lane / 4 and t = lane % 4, c[j][0..1] are row g,
// columns 8j + 2t + {0, 1}, and c[j][2..3] the same columns of row g + 8.
// An A operand (16 x 64, four k-steps of 16) is uint32_t a[4][4] of packed
// bf16 pairs; an accumulator re-packs into one with `to_a` (FlashAttention-2's
// register reuse), so S, P, dP and dS never leave registers. Column c and
// c + 32 of a row sit in the same thread (n-tiles j and j + 4), so a
// rotate-half pair is rotated in registers without a shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hd {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                    // rows of a tile
constexpr int LD = 72;                      // bf16 tile row stride (elements)
constexpr int TILE_ELEMS = TILE * LD;
constexpr int TILE_BYTES = TILE_ELEMS * 2;  // 9216
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without going through registers; zero-filled
// (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b, one m16n8k16 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// A fragments of rows [row0, row0 + 16) of a tile (ldmatrix lanes 0-15 give
// rows 0-15 at column 0 of the k-step, lanes 16-31 the same rows at column 8)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* s, int row0, int lane) {
  const bf16* p = s + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldsm_x4(a[ks], p + ks * 16);
}

// The accumulator as the A operand of the next product, rounded to bf16:
// k-step kk is n-tiles 2kk and 2kk + 1
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c (16 x 64) += A B^T, B a 64 x 64 tile in shared memory, [n][k]: S = Q K^T,
// dP = dO V^T and their transposes. ldmatrix without .trans; matrices
// 0-3 are (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* sB, int lane) {
  const bf16* p = sB + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      ldsm_x4(r, p + np * 16 * LD + ks * 16);
      mma(c[2 * np], a[ks], r[0], r[1]);
      mma(c[2 * np + 1], a[ks], r[2], r[3]);
    }
}

// c (16 x 64) += A B, B a 64 x 64 tile in shared memory, [k][n]: O += P V,
// dq += dS K, dV += P^T dO, dK += dS^T Q. ldmatrix.trans; matrices 0-3 are
// (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
__device__ __forceinline__ void mma_ab(float (&c)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* sB, int lane) {
  const bf16* p = sB + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, p + kk * 16 * LD + np * 16);
      mma(c[2 * np], a[kk], r[0], r[1]);
      mma(c[2 * np + 1], a[kk], r[2], r[3]);
    }
}

// One 64-key tile of the online softmax over a warp's rows g and g + 8, in
// registers. s holds S = q k^T for keys [k0, k0 + 64), unscaled, and becomes
// P = exp2(S * sl2 - m) (sl2 = scale * log2 e; keys >= L get P = 0
// explicitly); m (the running max, log2 units) and l (this thread's share of
// the running sum) move to this tile, and alpha returns the factors by
// which the caller rescales what it summed over the earlier tiles (0 on the
// first: m = -inf there, the new max finite).
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int L, float sl2,
                                               int lane) {
  const int t = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = k0 + 8 * n + 2 * t + (e & 1) < L;
      s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the quad holding the row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = k0 + 8 * n + 2 * t + (e & 1) < L;
      const float p = ok ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
      s[n][e] = p;
      l[e >> 1] += p;
    }
}

// Issue the copies of rows [row0, row0 + 64) of one (b, h) slice (`src` is
// its row 0, rows `row_stride` elements apart) into a tile; rows >= L are
// zero-filled. Every thread of the block takes part; no commit.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* src, int row0, int L,
                                          int row_stride) {
  for (int idx = threadIdx.x; idx < TILE * 8; idx += blockDim.x) {
    const int r = idx >> 3, ch = idx & 7, l = row0 + r;
    const bool ok = l < L;
    cp_async16(s + r * LD + ch * 8, ok ? src + (size_t)l * row_stride + ch * 8 : src, ok);
  }
}

// One rotate-half pair in f32, (a, b) -> (a cos - b sin, a sin + b cos),
// with each product and the sum rounded on its own (no FMA contraction), as
// apply_rope's separate multiplies and add round them: rounded to the input
// type, the rotated q and k are the plain version's bits, so lse and the
// forward's f32 output differ from the plain forward's only by summation
// order.
__device__ __forceinline__ float2 rope_pair(float a, float b, float c, float s) {
  return make_float2(__fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s)),
                     __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c)));
}

// Rotate the 8 rotate-half pairs (lo[e], hi[e]) of one row in place, in f32
// (rope_pair) and rounded to bf16; cos_row / sin_row are the row's table
// entries at the same columns (16-byte aligned f32)
__device__ __forceinline__ void rotate8(bf16* lo, bf16* hi, const float* cos_row,
                                        const float* sin_row) {
  uint4 x = *reinterpret_cast<const uint4*>(lo);
  uint4 y = *reinterpret_cast<const uint4*>(hi);
  const bf16* xe = reinterpret_cast<const bf16*>(&x);
  const bf16* ye = reinterpret_cast<const bf16*>(&y);
  const float4* cp = reinterpret_cast<const float4*>(cos_row);
  const float4* sp = reinterpret_cast<const float4*>(sin_row);
  const float4 c4[2] = {__ldg(cp), __ldg(cp + 1)}, s4[2] = {__ldg(sp), __ldg(sp + 1)};
  const float* cs = reinterpret_cast<const float*>(c4);
  const float* sn = reinterpret_cast<const float*>(s4);
  uint4 a, b;
  bf16* a_e = reinterpret_cast<bf16*>(&a);
  bf16* b_e = reinterpret_cast<bf16*>(&b);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 r = rope_pair(__bfloat162float(xe[e]), __bfloat162float(ye[e]), cs[e], sn[e]);
    a_e[e] = __float2bfloat16(r.x);
    b_e[e] = __float2bfloat16(r.y);
  }
  *reinterpret_cast<uint4*>(lo) = a;
  *reinterpret_cast<uint4*>(hi) = b;
}

// Rotate a landed q or k tile in place, rotate-half in f32 (rope_pair) and
// rounded to bf16, with [L, 32] f32 tables. Rows >= L (zeros) are left
// alone. Every thread takes part; the caller synchronises before and after.
__device__ __forceinline__ void rotate_tile(bf16* s, const float* cos_t, const float* sin_t,
                                            int row0, int L) {
  for (int idx = threadIdx.x; idx < TILE * 4; idx += blockDim.x) {
    const int r = idx >> 2, c0 = (idx & 3) * 8, l = row0 + r;
    if (l >= L) continue;
    bf16* p = s + r * LD + c0;
    rotate8(p, p + 32, cos_t + l * 32 + c0, sin_t + l * 32 + c0);
  }
}

// A warp's accumulator rows [row0, row0 + 16) of a tile, times the per-row
// factors f[0] (row g) and f[1] (row g + 8), rounded to bf16
__device__ __forceinline__ void stage(bf16* s, int row0, const float (&c)[8][4],
                                      const float (&f)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t* r0 = reinterpret_cast<uint32_t*>(s + (row0 + g) * LD + 2 * t);
  uint32_t* r8 = reinterpret_cast<uint32_t*>(s + (row0 + g + 8) * LD + 2 * t);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r0[4 * j] = pack(c[j][0] * f[0], c[j][1] * f[0]);
    r8[4 * j] = pack(c[j][2] * f[1], c[j][3] * f[1]);
  }
}

// Scale an accumulator whose rows are sequence positions l0 + g and l0 + g +
// 8 and rotate it back by the inverse RoPE, in f32: (a, b) -> (a cos + b sin,
// b cos - a sin) over the pairs (c, c + 32), which are n-tiles j and j + 4 of
// the same thread. Rows >= L are left as they are (never stored).
__device__ __forceinline__ void scale_rotate_back(float (&c)[8][4], const float* cos_t,
                                                  const float* sin_t, int l0, int L,
                                                  float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = l0 + g + 8 * half;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 cs = __ldg(reinterpret_cast<const float2*>(cos_t + l * 32 + 8 * j + 2 * t));
      const float2 sn = __ldg(reinterpret_cast<const float2*>(sin_t + l * 32 + 8 * j + 2 * t));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float co = e ? cs.y : cs.x, si = e ? sn.y : sn.x;
        const float a = c[j][2 * half + e] * scale, b = c[j + 4][2 * half + e] * scale;
        c[j][2 * half + e] = a * co + b * si;
        c[j + 4][2 * half + e] = b * co - a * si;
      }
    }
  }
}

// A warp's 16 staged rows [row0, row0 + 16) of a tile into dst + l *
// row_stride for l = l0 + r < L, 16 bytes a lane (eight lanes a row)
__device__ __forceinline__ void store_rows16(bf16* dst, int row_stride, const bf16* s, int row0,
                                             int l0, int L, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, r = idx >> 3, ch = idx & 7;
    if (l0 + r < L)
      *reinterpret_cast<uint4*>(dst + (size_t)(l0 + r) * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(s + (row0 + r) * LD + ch * 8);
  }
}

}  // namespace tc
}  // namespace hd
