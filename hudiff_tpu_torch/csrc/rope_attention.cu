// K1, K5 and K7: one hand-written attention forward, instantiated three
// times for three layouts.
//
// Replaces, in hudiff_tpu/ops/pallas_attention.py:
//   K1 _rope_fwd_kernel_qkv (via _pallas_fwd_qkv / rope_attention_qkv):
//      RoPE attention over a head-major merged qkv [B, L, H*3*64];
//   K5 _rope_fwd_kernel (via _pallas_fwd / rope_attention): the same on
//      separate q, k, v [B, L, H*64];
//   K7 _attn_kernel (via fused_attention / attention): softmax attention
//      without RoPE on [B, H, L, 64] (or [B, L, H, 64]), forward only.
//
// What it computes, per batch row b and head h (D = 64):
//   q, k = rope(q), rope(k)                      rotate-half, in f32 with the
//                                                plain version's roundings
//                                                (tc::rope_pair), rounded to
//                                                the input type (K1, K5; K7
//                                                takes q, k as they are)
//   S    = (q k^T in the input type, f32 accumulation) * scale
//   P    = softmax(S) over all L keys (no mask: the pad token is a token)
//   out  = P v, P rounded to v's type, f32 accumulation
// and, when the caller asks (K1 and K5 under autograd; their own kernel
// instantiations), the backward's residuals for rope_attention_bwd.cu:
//   lse     = log sum_keys exp(S), per query row, f32 [B, H, L];
//   out_f32 = P v with P in f32, f32 (bf16 only: in f32 it is out). The
//             backward takes delta = rowsum(dO * out_f32), which needs P
//             unrounded (see rope_attention_bwd.cu).
// K7's TPU kernel casts q and k to f32 before the product; a product of two
// bf16 values is exact in f32, so bf16 products with f32 accumulation compute
// the same sums.
//
// Layout: each operand is reached through a base pointer and a Layout
// (batch stride, row stride, per-head offset); q, k and v share one, out has
// its own. K1 points q, k, v at columns 0, 64, 128 of the merged qkv.
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): bytes. At B=64, L=291, bf16 one K1 call reads the 57 MB qkv block
// and writes 19 MB, about 23 us at 3.35 TB/s, against 11 GFLOP (11 us at
// 989 TFLOP/s) of tensor-core work; K5 and K7 move the same bytes.
//
// Design, bf16 (FlashAttention-2's forward on mma.sync; csrc/mma_tiles.cuh):
// the [291, 291] f32 score block (339 KB) does not fit a block's 227 KB, so
// one block of four warps takes (b, h, 64 queries) and walks the keys in
// tiles of 64 with an online softmax. The q tile is rotated once in shared
// memory and held as A fragments in registers. K/V tiles arrive by cp.async
// into a double buffer (the next tile's copy overlaps this tile's products);
// a landed k tile is rotated in place. Each warp keeps its 16 rows of S, P
// and O in registers: S = q k^T by m16n8k16 products, the row max and sum by
// quad shuffles (exp2 of scaled log2 scores), P re-packed as bf16 A
// fragments for O += P V, O rescaled in registers; no S, P or O tile goes
// through shared memory. Keys >= L get P = 0 explicitly; rows >= L are never
// stored. The output is staged through the free q tile and written 16 bytes
// a lane. Each query tile reads its head's K/V again; the repeats hit L2.
// The residual instantiations split P into bf16(P) and the rest, which
// rounding dropped, and accumulate (P - bf16(P)) V as a second product, so
// that out_f32 = (P v)/l carries P to ~2^-16; one more product per tile.
// f32 (the tests' reference type) keeps the exact FMA path of
// attention_tiles.cuh: S and O in f32 shared tiles, one warp reduction per
// row. The three instantiations have their own kernel names, so a profiler
// tells them apart.

#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

using namespace hd;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;               // [B, H, L] f32 (residual kernels only)
  float* out_f32;           // out unrounded, f32, out's layout (bf16 residual kernels only)
  Layout in, o;             // q, k, v share `in`
  const float *cos_t, *sin_t;  // [L, 32] f32 (unused without RoPE)
  int L;
  float scale;
};

// ---- f32: the exact FMA path ------------------------------------------------

struct SmemF32 {
  static constexpr int LDT = ldt<float>();  // q/k/v and probability tile row stride
  static constexpr int TILE = BQ * LDT * 4;
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + TILE, 128);
  static constexpr int V = round_up(K + TILE, 128);
  static constexpr int P = round_up(V + TILE, 128);
  static constexpr int S = round_up(P + TILE, 128);
  static constexpr int O = round_up(S + BQ * LDF * 4, 128);
  static constexpr int BYTES = round_up(O + BQ * LDF * 4, 128);
};

// One 64-row f32 tile of q or k (rotated when ROPE) and v, held in
// registers between the global loads and the shared-memory stores. Rotated
// item: one row's columns [c, c + 4) and [c + 32, c + 36) with their cos/sin.
template <bool ROPE> struct TileRegs {
  static constexpr int V = 4;
  static constexpr int NR = 64 * (D2 / V) / THREADS;  // rotated items per thread
  static constexpr int NV = 64 * (HD / V) / THREADS;  // plain vectors per thread
  float4 x0[NR], x1[NR], v[NV];
  float4 cs[NR], sn[NR];

  // rows [row0, row0 + 64) of one (b, h) slice: `src` is its q or k row 0,
  // `vsrc` its v row 0 (nullptr: no v); rows are `row_stride` apart
  __device__ void load(const float* src, const float* vsrc, const float* cos_t,
                       const float* sin_t, int row0, int L, int row_stride) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V, l = row0 + r;
      x0[i] = x1[i] = cs[i] = sn[i] = z;
      if (l < L) {
        const float* p = src + (size_t)l * row_stride + c0;
        x0[i] = *reinterpret_cast<const float4*>(p);
        x1[i] = *reinterpret_cast<const float4*>(p + D2);
        if (ROPE) {
          cs[i] = *reinterpret_cast<const float4*>(cos_t + l * D2 + c0);
          sn[i] = *reinterpret_cast<const float4*>(sin_t + l * D2 + c0);
        }
      }
    }
    if (vsrc == nullptr) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V, l = row0 + r;
      v[i] = l < L ? *reinterpret_cast<const float4*>(vsrc + (size_t)l * row_stride + c0) : z;
    }
  }

  // rotate, (a, b) -> (a cos - b sin, a sin + b cos) as tc::rope_pair
  // rounds it, or (without ROPE) store as loaded
  __device__ void store(float* s_rot, float* s_v) {
    constexpr int LDT = SmemF32::LDT;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V;
      float4 lo = x0[i], hi = x1[i];
      if (ROPE) {
        const float* x = reinterpret_cast<const float*>(&x0[i]);
        const float* y = reinterpret_cast<const float*>(&x1[i]);
        const float* c = reinterpret_cast<const float*>(&cs[i]);
        const float* s = reinterpret_cast<const float*>(&sn[i]);
        float* lo_e = reinterpret_cast<float*>(&lo);
        float* hi_e = reinterpret_cast<float*>(&hi);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float2 r = tc::rope_pair(x[e], y[e], c[e], s[e]);
          lo_e[e] = r.x;
          hi_e[e] = r.y;
        }
      }
      *reinterpret_cast<float4*>(s_rot + r * LDT + c0) = lo;
      *reinterpret_cast<float4*>(s_rot + r * LDT + c0 + D2) = hi;
    }
    if (s_v == nullptr) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V;
      *reinterpret_cast<float4*>(s_v + r * LDT + c0) = v[i];
    }
  }
};

template <bool ROPE, bool RES>
__device__ __forceinline__ void attention_fwd_f32(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = SmemF32;
  float* sQ = reinterpret_cast<float*>(smem + SM::Q);
  float* sK = reinterpret_cast<float*>(smem + SM::K);
  float* sV = reinterpret_cast<float*>(smem + SM::V);
  float* sP = reinterpret_cast<float*>(smem + SM::P);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sO = reinterpret_cast<float*>(smem + SM::O);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L;
  const float* q = static_cast<const float*>(a.q) + a.in.at(b, h);
  const float* k = static_cast<const float*>(a.k) + a.in.at(b, h);
  const float* v = static_cast<const float*>(a.v) + a.in.at(b, h);

  TileRegs<ROPE> regs;
  regs.load(q, nullptr, a.cos_t, a.sin_t, q0, L, a.in.row);
  regs.store(sQ, nullptr);
  regs.load(k, v, a.cos_t, a.sin_t, 0, L, a.in.row);
  for (int idx = threadIdx.x; idx < BQ * LDF; idx += THREADS) sO[idx] = 0.f;

  // every lane of a warp tracks the running max / sum of the warp's 16 rows
  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f;

  Acc<float> acc;
  for (int k0 = 0; k0 < L; k0 += BKV) {
    __syncthreads();  // previous tile's sK / sV fully read
    regs.store(sK, sV);
    __syncthreads();
    if (k0 + BKV < L)  // next tile's loads overlap this tile's compute
      regs.load(k, v, a.cos_t, a.sin_t, k0 + BKV, L, a.in.row);

    acc.zero();
    acc.abt(sQ, sK, warp, lane);  // S = Q K^T, unscaled
    acc.store(sS, warp, lane);
    __syncwarp();
    softmax_tile(sS, sP, sO, m_run, l_run, k0, L, a.scale, warp, lane);
    __syncwarp();
    acc.load(sO, warp, lane);     // O += P V
    acc.ab(sP, sV, warp, lane);
    acc.store(sO, warp, lane);
  }
  __syncwarp();
  store_rows(static_cast<float*>(a.out) + a.o.at(b, h), a.o.row, sO, l_run, q0, L, warp, lane);
  if (RES && lane == 0) {
    float* lse = a.lse + ((size_t)b * gridDim.y + h) * L;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int l = q0 + warp * 16 + r;
      if (l < L) lse[l] = m_run[r] + logf(l_run[r]);
    }
  }
}

// ---- bf16: register tiles on mma.sync ----------------------------------------

struct SmemBf16 {  // the q tile, then K and V double buffers
  static constexpr int Q = 0;
  static constexpr int K = tc::TILE_ELEMS;       // elements; buffer i at K + i * TILE_ELEMS
  static constexpr int V = 3 * tc::TILE_ELEMS;
  static constexpr int BYTES = 5 * tc::TILE_BYTES;
};

template <bool ROPE, bool RES>
__device__ __forceinline__ void attention_fwd_bf16(const Args& a) {
  using tc::bf16;
  using tc::TILE_ELEMS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem) + SmemBf16::Q;
  bf16* sK = reinterpret_cast<bf16*>(smem) + SmemBf16::K;
  bf16* sV = reinterpret_cast<bf16*>(smem) + SmemBf16::V;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L, rs = a.in.row;
  const int g = lane >> 2, t = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + a.in.at(b, h);
  const bf16* k = static_cast<const bf16*>(a.k) + a.in.at(b, h);
  const bf16* v = static_cast<const bf16*>(a.v) + a.in.at(b, h);
  const int nk = (L + BKV - 1) / BKV;

  tc::load_tile(sQ, q, q0, L, rs);
  tc::load_tile(sK, k, 0, L, rs);
  tc::load_tile(sV, v, 0, L, rs);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();
  if (ROPE) {
    tc::rotate_tile(sQ, a.cos_t, a.sin_t, q0, L);
    tc::rotate_tile(sK, a.cos_t, a.sin_t, 0, L);
    __syncthreads();
  }
  uint32_t qf[4][4];
  tc::load_a(qf, sQ, warp * 16, lane);

  // rows g and g + 8 of the warp: running max (log2 units) and this
  // thread's share of the running sum. With RES, o_lo accumulates the part
  // of P that rounding to bf16 dropped, so that o + o_lo is P v with f32 P.
  float o[8][4], o_lo[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  tc::zero(o);
  if (RES) tc::zero(o_lo);
  const float sl2 = a.scale * tc::LOG2E;
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1, k0 = j * BKV;
    const bf16* cK = sK + buf * TILE_ELEMS;
    const bf16* cV = sV + buf * TILE_ELEMS;
    if (j + 1 < nk) {  // the next tile's copy overlaps this tile's products
      tc::load_tile(sK + (buf ^ 1) * TILE_ELEMS, k, k0 + BKV, L, rs);
      tc::load_tile(sV + (buf ^ 1) * TILE_ELEMS, v, k0 + BKV, L, rs);
      tc::cp_async_commit();
    }
    float s[8][4];
    tc::zero(s);
    tc::mma_abt(s, qf, cK, lane);  // S = q k^T, unscaled

    float alpha[2];
    tc::online_softmax(s, m, l, alpha, k0, L, sl2, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[n][e] *= alpha[e >> 1];
        if (RES) o_lo[n][e] *= alpha[e >> 1];
      }
    uint32_t pf[4][4];
    tc::to_a(pf, s);               // P rounded to bf16
    tc::mma_ab(o, pf, cV, lane);   // O += P V
    if (RES) {                     // O_lo += (P - bf16(P)) V
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] -= __bfloat162float(__float2bfloat16(s[n][e]));
      tc::to_a(pf, s);
      tc::mma_ab(o_lo, pf, cV, lane);
    }

    if (j + 1 < nk) {
      tc::cp_async_wait_all();
      __syncthreads();  // the next tile landed; every warp is done with this one
      if (ROPE) {
        tc::rotate_tile(sK + (buf ^ 1) * TILE_ELEMS, a.cos_t, a.sin_t, k0 + BKV, L);
        __syncthreads();
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  // sQ's rows of this warp were read only by this warp (load_a): stage there
  tc::stage(sQ, warp * 16, o, inv, lane);
  __syncwarp();
  tc::store_rows16(static_cast<bf16*>(a.out) + a.o.at(b, h), a.o.row, sQ, warp * 16,
                   q0 + warp * 16, L, lane);
  if (!RES) return;
  float* lse = a.lse + ((size_t)b * gridDim.y + h) * L;
  float* of = a.out_f32 + a.o.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    if (t == 0) lse[row] = (m[r] + log2f(l[r])) * tc::LN2;
    float* dst = of + (size_t)row * a.o.row + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2((o[n][2 * r] + o_lo[n][2 * r]) * inv[r],
                      (o[n][2 * r + 1] + o_lo[n][2 * r + 1]) * inv[r]);
  }
}

// RES: also write the backward's residuals, lse and (bf16) the unrounded
// output
template <typename T, bool ROPE, bool RES>
__device__ __forceinline__ void attention_fwd(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    attention_fwd_f32<ROPE, RES>(a);
  else
    attention_fwd_bf16<ROPE, RES>(a);
}

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS) rope_attention_qkv_kernel(Args a) {
  attention_fwd<T, true, RES>(a);
}
template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_fwd_kernel(Args a) {
  attention_fwd<T, true, RES>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) plain_attention_kernel(Args a) {
  attention_fwd<T, false, false>(a);
}

template <typename T, void (*KERNEL)(Args)>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr int bytes = std::is_same<T, float>::value ? SmemF32::BYTES : SmemBf16::BYTES;
  // set once per instantiation: the port drives one card per process
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.L + BQ - 1) / BQ, H, B);
  KERNEL<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// One of K1's or K5's four instantiations: dtype, and the residuals or not
template <void (*F)(Args), void (*F_RES)(Args), void (*H)(Args), void (*H_RES)(Args)>
int launch_rope(const Args& a, int B, int heads, int dtype, cudaStream_t s) {
  const bool res = a.lse != nullptr;
  if (dtype == 0)
    return res ? launch<float, F_RES>(a, B, heads, s) : launch<float, F>(a, B, heads, s);
  if (dtype == 1)
    return res ? launch<__nv_bfloat16, H_RES>(a, B, heads, s)
               : launch<__nv_bfloat16, H>(a, B, heads, s);
  return (int)cudaErrorInvalidValue;
}

// residuals are lse and, for bf16, out_f32: both or neither
bool bad_args(int B, int L, int H, int head_dim, const void* lse, const void* out_f32,
              int dtype) {
  return head_dim != HD || B <= 0 || L <= 0 || H <= 0 || H > 65535 || B > 65535 ||
         (lse == nullptr && out_f32 != nullptr) ||
         (lse != nullptr && dtype == 1 && out_f32 == nullptr);
}

}  // namespace

// qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, out [B, L, H*64]. The
// backward's residuals, or null (not written): lse [B, H, L] f32 and, for
// bf16, out_f32 [B, L, H*64] f32, out before rounding (for f32, out is
// it). dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 =
// launched).
extern "C" int hd_rope_attention_qkv(const void* qkv, const void* cos_t, const void* sin_t,
                                     void* out, void* lse, void* out_f32, int B, int L, int H,
                                     int head_dim, float scale, int dtype, void* stream) {
  if (bad_args(B, L, H, head_dim, lse, out_f32, dtype)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  const Args a{base, base + HD * es, base + 2 * HD * es, out, static_cast<float*>(lse),
               static_cast<float*>(out_f32), Layout{L * 3 * H * HD, 3 * H * HD, 3 * HD},
               Layout{L * H * HD, H * HD, HD}, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), L, scale};
  return launch_rope<rope_attention_qkv_kernel<float, false>,
                     rope_attention_qkv_kernel<float, true>,
                     rope_attention_qkv_kernel<__nv_bfloat16, false>,
                     rope_attention_qkv_kernel<__nv_bfloat16, true>>(
      a, B, H, dtype, static_cast<cudaStream_t>(stream));
}

// q, k, v, out [B, L, H*64] (K5), cos/sin [L, 32] f32, residuals and dtype as
// above.
extern "C" int hd_rope_attention(const void* q, const void* k, const void* v,
                                 const void* cos_t, const void* sin_t, void* out, void* lse,
                                 void* out_f32, int B, int L, int H, int head_dim, float scale,
                                 int dtype, void* stream) {
  if (bad_args(B, L, H, head_dim, lse, out_f32, dtype)) return (int)cudaErrorInvalidValue;
  const Layout lay{L * H * HD, H * HD, HD};
  const Args a{q, k, v, out, static_cast<float*>(lse), static_cast<float*>(out_f32), lay, lay,
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, scale};
  return launch_rope<rope_attention_sep_fwd_kernel<float, false>,
                     rope_attention_sep_fwd_kernel<float, true>,
                     rope_attention_sep_fwd_kernel<__nv_bfloat16, false>,
                     rope_attention_sep_fwd_kernel<__nv_bfloat16, true>>(
      a, B, H, dtype, static_cast<cudaStream_t>(stream));
}

// K7: q, k, v with element (b, h, l, c) at b*in_batch + h*in_head + l*in_row + c,
// out likewise with the out_* strides; no RoPE, no residuals; dtype as above.
extern "C" int hd_attention(const void* q, const void* k, const void* v, void* out, int B,
                            int L, int H, int head_dim, int in_batch, int in_row, int in_head,
                            int out_batch, int out_row, int out_head, float scale, int dtype,
                            void* stream) {
  if (bad_args(B, L, H, head_dim, nullptr, nullptr, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, nullptr, nullptr, Layout{in_batch, in_row, in_head},
               Layout{out_batch, out_row, out_head}, nullptr, nullptr, L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, plain_attention_kernel<float>>(a, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, plain_attention_kernel<__nv_bfloat16>>(a, B, H, s);
  return (int)cudaErrorInvalidValue;
}
