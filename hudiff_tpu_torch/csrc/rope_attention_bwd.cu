// K3 and K6: backward of the fused rotate-half RoPE attention, from the
// forward's residuals, as three launches, instantiated for two layouts.
//
// Replaces, in hudiff_tpu/ops/pallas_attention.py:
//   K3 _rope_bwd_kernel_qkv (via _pallas_bwd_qkv, the backward of the custom
//      VJP around K1): q, k, v and their gradients in one head-major merged
//      [B, L, H*3*64] tensor each;
//   K6 _rope_bwd_kernel (via _pallas_bwd, the backward of the custom VJP
//      around K5): separate q, k, v and dq, dk, dv, each [B, L, H*64].
//
// What it computes, per batch row b and head h (D = 64), with T the input
// type (f32 or bf16) and every product of T values accumulated in f32:
//   qh, kh = T(rope(q)), T(rope(k))            rotate-half, in f32, rounded
//                                               as the forward rounds it
//                                               (tc::rope_pair)
//   P      = exp(qh kh^T * scale - lse)         f32; lse, the row log-sum-exp,
//                                               from the forward (K1, K5)
//   dv     = T(P)^T dO
//   dP     = dO v^T ; delta = rowsum(dO * o)   (* elementwise; o = P v with
//                                               f32 P, from the forward)
//   dS     = T(P * (dP - delta))
//   dq     = rope^T(dS kh * scale), dk = rope^T(dS^T qh * scale), in f32
//   dq, dk, dv rounded to T
// The TPU kernel recomputes the softmax and takes delta = rowsum(dP * P)
// over f32 P: P from lse is the same P within f32 ulps, and dO * (P v) is
// the same sum in another order. The choice of o matters in bf16. The
// stored output has P rounded to bf16 and is itself rounded; delta from it
// moves dq and dk toward the card's limit (5e-3 past one bf16 spacing),
// most at short L, where attention is peaked and the output large: by up to
// 4.1e-3 at L = 37 on the CPU (tests/test_torch_attention_residuals.py),
// and chip_smoke.py reads it on the card at L = 17, 37, 100 and 291 beside
// the gate (PERF.md). An f32 copy with P still rounded moved them nearly as
// far. So the forward, when asked, also writes o with P carried to ~2^-16
// (rope_attention.cu, out_f32), and delta from it matches the Pallas
// kernel's within 1e-4. (A dq pass that summed rowsum(dP * P) itself would
// walk the keys twice.)
// q, k, v and dq, dk, dv share one Layout (batch stride, row stride,
// per-head offset); dO and out_f32 are [B, L, H*64]; lse and delta
// [B, H, L] f32.
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): at B=128, L=291, bf16 the function reads q, k, v and dO (143 MB)
// and writes dq, dk, dv (114 MB), 0.080 ms at 3.35 TB/s, against five
// 2*L^2*D products per (row, head), 55.5 GFLOP or 0.056 ms at 989 TFLOP/s:
// bytes, narrowly. (The residuals and the scratch are this design's bytes,
// not the function's, and the bound leaves them out.) As built it executes
// seven products (S and dP in both passes), 77.7 GFLOP. What the card
// actually spends goes to a chain a block runs per walked tile (S and dP,
// the exponentials, dS, the products it feeds) and to the work around it
// (loads, rotations, stores) that nothing overlaps.
//
// Hopper blocks cannot carry dK, dV across a grid, so both designs take two
// passes after a prologue, with no atomics and the same bits every run:
// (dq) resident 64 queries walk the keys, dq += dS k; (dkv) resident 64 keys
// walk the queries, dV += P^T dO, dK += dS^T q. Keys and queries >= L get
// P = 0 explicitly; rows >= L are never written.
//
// Design, bf16 on Hopper (TMA + mbarriers + wgmma on wgmma_tiles.cuh;
// wgmma_rope_attention_[sep_]bwd_{dq,dkv}_kernel<GROUPS>; L <= 384, where a
// head's walked pair fits shared memory; ops/fused_attention.py::
// rope_attention_bwd_plan picks it where it reads faster, PERF.md):
//   (p) the prologue takes delta = rowsum(dO * out_f32) alone;
//   a block takes (head h, row b) and every split-th of the head's 64-row
//   tiles, GROUPS (1 or 2) warpgroups of 128 threads taking them in turn.
//   Thread 0 issues every copy at once: the cos and sin tables (one bulk
//   copy each), each warpgroup's first resident pair (q and dO, or k and v)
//   on its own mbarrier, the head's walked K (or Q) on one mbarrier, each
//   walked V (or dO) tile on its own, the other resident pairs; 128-byte
//   swizzled tiles from 3-D tensor maps over the inputs themselves (qkv for
//   K3, q, k, v for K6; dO), rows past L TMA's zeros. The block's threads
//   rotate the walked K or Q in place once, a warpgroup its resident q or k,
//   with the tables in shared memory. Per walked tile a warpgroup runs S =
//   R0 W0^T and dP = R1 W1^T (both operands K-major, from shared memory),
//   P = exp2 on the special-function unit (ex2.approx.ftz), dS = P (dP -
//   delta) as bf16 register A fragments, and dq += dS K or dK += dS^T Q
//   (and dV += P^T dO) with the walked tile as the N-major B operand. The
//   dq pass holds two score buffers, so tile j + 1's S and dP run under
//   tile j's exponentials; the dkv pass (four accumulators) issues dV as
//   soon as P is ready, under the wait for dP. The scores are written by
//   the products alone and P, dS have registers of their own: ptxas
//   serializes wgmma whose accumulators ordinary instructions write, and it
//   did so, for want of registers, while a producer warp made a third warp
//   on one sub-partition (168 registers a thread); without it a thread may
//   keep 255. dq and dk are scaled and rotated back in f32, staged in the
//   warp's own rows of the resident tile and written 16 bytes a lane.
//
// Design, bf16 mma.sync (FlashAttention-2's backward on csrc/mma_tiles.cuh),
// which the plan keeps past L = 384, where a head's walked pair does not
// fit a block's shared memory:
//   (p) one block per (b, h, 64 rows) rotates q and k once into a
//       head-contiguous [B, H, L, 64] scratch in T and takes delta;
//   (dq) one block per (b, h, 64 queries) holds its rotated q and dO rows as
//       A fragments in registers and walks the key tiles once: S = q k^T,
//       dP = dO v^T, P = exp2(S scale log2e - lse log2e), dS = P (dP -
//       delta) re-packed as bf16 A fragments, dq += dS k;
//   (dkv) one block per (b, h, 64 keys) holds its rotated k and v rows as A
//       fragments and walks the query tiles once: S^T = k q^T, dP^T = v dO^T,
//       P^T and dS^T in registers from the tile's lse and delta,
//       dV += P^T dO, dK += dS^T q (ldmatrix.trans reads dO and q as the B
//       operands).
// Tiles arrive by cp.async into a double buffer, one barrier a tile; four
// warps a block, several blocks an SM, so one block's loads run under
// another's products. At the paths' shapes it read slower than the Hopper
// design everywhere but L = 17, where either reads within 4% of the other,
// one way or the other by shape (PERF.md).
// f32 (the tests' reference type, and the f32 card-vs-CPU train step) keeps
// the exact FMA path of attention_tiles.cuh on the mma.sync design's
// prologue and residuals. K3's kernels contain rope_attention_bwd_, K6's
// rope_attention_sep_bwd_ (and not rope_attention_bwd_): one body, two
// names on each design.

#include <initializer_list>
#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

using namespace hd;

namespace {

constexpr int BT = 64;       // queries or keys per tile

struct Args {
  const void *q, *k, *v;    // Layout `in`; q and k are read by the prologue only
  const void* dout;         // [B, L, H*64]
  const float* out_f32;     // [B, L, H*64] f32, the forward's unrounded output
  const float* lse;         // [B, H, L] f32, from the forward
  void *qr, *kr;            // [B, H, L, 64] T scratch: T(rope(q)), T(rope(k)); null on Hopper
  float* delta;             // [B, H, L] f32 scratch
  void *dq, *dk, *dv;       // Layout `in`
  Layout in;
  const float *cos_t, *sin_t;
  int L;
  float scale;
};

// Where one (b, h) slice starts: in q, k, v and their gradients (`in`), in
// dO and out_f32 ([B, L, H*64]), in lse and delta ([B, H, L]) and in the
// rotated scratch ([B, H, L, 64]).
struct Slice {
  size_t bh, orow, srow, rrow;
  int H;
  __device__ Slice(const Args& a) {
    const int h = blockIdx.y, b = blockIdx.z;
    H = gridDim.y;
    bh = a.in.at(b, h);
    orow = ((size_t)b * a.L * H + h) * HD;
    srow = ((size_t)b * H + h) * a.L;
    rrow = srow * HD;
  }
};

// ---- (p) the prologue, both types -------------------------------------------

// Rows [r0, r0 + 64) of one (b, h): q and k rotated in f32 and rounded to T
// into the head-contiguous scratch (none on the Hopper path, whose passes
// rotate their tiles themselves: a.qr null), and delta = rowsum(dO *
// out_f32) in f32.
template <typename T>
__device__ __forceinline__ void bwd_prep(const Args& a) {
  constexpr int V = Cfg<T>::VEC;  // elements in 16 bytes
  constexpr int ITEMS = BT * (D2 / V);
  const Slice sl(a);
  const int r0 = blockIdx.x * BT, L = a.L, H = sl.H;
  for (int idx = threadIdx.x; a.qr != nullptr && idx < 2 * ITEMS; idx += THREADS) {
    const int which = idx / ITEMS, rem = idx % ITEMS;  // which: 0 q, 1 k
    const int r = rem / (D2 / V), c0 = (rem % (D2 / V)) * V, l = r0 + r;
    if (l >= L) continue;
    const T* src = static_cast<const T*>(which ? a.k : a.q) + sl.bh + (size_t)l * a.in.row + c0;
    T* dst = static_cast<T*>(which ? a.kr : a.qr) + sl.rrow + (size_t)l * HD + c0;
    Pack<T> x, y, lo, hi;
    x.u = __ldg(reinterpret_cast<const uint4*>(src));
    y.u = __ldg(reinterpret_cast<const uint4*>(src + D2));
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float2 rq = tc::rope_pair(to_f(x[e]), to_f(y[e]), a.cos_t[l * D2 + c0 + e],
                                      a.sin_t[l * D2 + c0 + e]);
      lo[e] = from_f<T>(rq.x);
      hi[e] = from_f<T>(rq.y);
    }
    *reinterpret_cast<uint4*>(dst) = lo.u;
    *reinterpret_cast<uint4*>(dst + D2) = hi.u;
  }
  // row r0 + tid / 2, half a row a thread; every load issued before the sum
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, l = r0 + r;
  float d = 0.f;
  if (l < L) {
    const size_t off = sl.orow + (size_t)l * H * HD + half * D2;
    const uint4* dp = reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + off);
    const float4* op = reinterpret_cast<const float4*>(a.out_f32 + off);
    Pack<T> g[D2 / V];
    float4 o[D2 / 4];
#pragma unroll
    for (int c = 0; c < D2 / V; ++c) g[c].u = __ldg(dp + c);
#pragma unroll
    for (int c = 0; c < D2 / 4; ++c) o[c] = __ldg(op + c);
    const float* of = reinterpret_cast<const float*>(o);
#pragma unroll
    for (int c = 0; c < D2 / V; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) d += to_f(g[c][e]) * of[c * V + e];
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (half == 0 && l < L) a.delta[sl.srow + l] = d;
}

// ---- f32: the exact FMA path ------------------------------------------------

// Shared memory: six f32 tiles [64][LDT] and two [64][LDF], plus a query
// tile's lse and delta.
struct SmemF32 {
  static constexpr int LDT = ldt<float>();
  static constexpr int TILE = round_up(BT * LDT * 4, 128);
  static constexpr int FTILE = round_up(BT * LDF * 4, 128);
  static constexpr int F0 = 6 * TILE;                // 2 f32 accumulator tiles
  static constexpr int ST = F0 + 2 * FTILE;          // 2 x 64 f32
  static constexpr int BYTES = ST + 2 * BT * 4;
};

// rows [row0, row0 + 64) of one (b, h) slice (`src` its row 0, rows
// `row_stride` apart); zero rows past L
__device__ void load_plain(float* dst, const float* src, int row0, int L, int row_stride) {
  constexpr int LDT = SmemF32::LDT;
  for (int idx = threadIdx.x; idx < BT * (HD / 4); idx += THREADS) {
    const int r = idx / (HD / 4), c0 = (idx % (HD / 4)) * 4, l = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < L) v = *reinterpret_cast<const float4*>(src + (size_t)l * row_stride + c0);
    *reinterpret_cast<float4*>(dst + r * LDT + c0) = v;
  }
}

// a query tile's lse and delta (zero past L)
__device__ void load_stats_f32(float* s_lse, float* s_delta, const Args& a, const Slice& sl,
                               int q0) {
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const bool ok = q0 + i < a.L;
    s_lse[i] = ok ? a.lse[sl.srow + q0 + i] : 0.f;
    s_delta[i] = ok ? a.delta[sl.srow + q0 + i] : 0.f;
  }
}

// One output row's 64 columns from an f32 tile row: rotated back by the
// inverse RoPE after scaling (rot = true), or as they are.
__device__ void write_row(float* dst, const float* row, const float* cos_t, const float* sin_t,
                          int l, float scale, bool rot, int lane) {
  if (rot) {
    const float a = row[lane] * scale, b = row[lane + D2] * scale;
    const float c = cos_t[l * D2 + lane], s = sin_t[l * D2 + lane];
    dst[lane] = a * c + b * s;
    dst[lane + D2] = b * c - a * s;
  } else {
    dst[lane] = row[lane];
    dst[lane + D2] = row[lane + D2];
  }
}

__device__ __forceinline__ void bwd_dq_f32(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = SmemF32;
  constexpr int LDT = SM::LDT;
  float* sQ = reinterpret_cast<float*>(smem + 0 * SM::TILE);
  float* sDO = reinterpret_cast<float*>(smem + 1 * SM::TILE);
  float* sK = reinterpret_cast<float*>(smem + 2 * SM::TILE);
  float* sV = reinterpret_cast<float*>(smem + 3 * SM::TILE);
  float* sDS = reinterpret_cast<float*>(smem + 4 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);
  float* sLse = reinterpret_cast<float*>(smem + SM::ST);
  float* sD = sLse + BT;

  const Slice sl(a);
  const int q0 = blockIdx.x * BT, L = a.L, H = sl.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const float scale = a.scale;
  const float* qr = static_cast<const float*>(a.qr) + sl.rrow;
  const float* kr = static_cast<const float*>(a.kr) + sl.rrow;
  const float* v = static_cast<const float*>(a.v) + sl.bh;
  const float* dout = static_cast<const float*>(a.dout) + sl.orow;

  load_plain(sQ, qr, q0, L, HD);
  load_plain(sDO, dout, q0, L, H * HD);
  load_stats_f32(sLse, sD, a, sl, q0);

  Acc<float> acc, dq;
  dq.zero();
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // previous tile fully read
    load_plain(sK, kr, k0, L, HD);
    load_plain(sV, v, k0, L, rs);
    __syncthreads();
    acc.zero();
    acc.abt(sQ, sK, warp, lane);
    acc.store(sS, warp, lane);
    acc.zero();
    acc.abt(sDO, sV, warp, lane);
    acc.store(sDP, warp, lane);
    __syncwarp();
    const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const bool okq = q0 + row < L;
      const float lse = sLse[row], delta = sD[row];
      const float p0 = okq && ok0 ? expf(sS[row * LDF + lane] * scale - lse) : 0.f;
      const float p1 = okq && ok1 ? expf(sS[row * LDF + lane + 32] * scale - lse) : 0.f;
      sDS[row * LDT + lane] = p0 * (sDP[row * LDF + lane] - delta);
      sDS[row * LDT + lane + 32] = p1 * (sDP[row * LDF + lane + 32] - delta);
    }
    __syncwarp();
    dq.ab(sDS, sK, warp, lane);  // the warp's own dS rows, every key
  }
  __syncwarp();
  dq.store(sS, warp, lane);  // the warp's own rows of sS
  __syncwarp();
  float* dst = static_cast<float*>(a.dq) + sl.bh;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, l = q0 + row;
    if (l < L)
      write_row(dst + (size_t)l * rs, sS + row * LDF, a.cos_t, a.sin_t, l, scale, true, lane);
  }
}

__device__ __forceinline__ void bwd_dkv_f32(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = SmemF32;
  float* sK = reinterpret_cast<float*>(smem + 0 * SM::TILE);
  float* sV = reinterpret_cast<float*>(smem + 1 * SM::TILE);
  float* sQ = reinterpret_cast<float*>(smem + 2 * SM::TILE);
  float* sDO = reinterpret_cast<float*>(smem + 3 * SM::TILE);
  float* sP = reinterpret_cast<float*>(smem + 4 * SM::TILE);
  float* sDS = reinterpret_cast<float*>(smem + 5 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);
  float* sLse = reinterpret_cast<float*>(smem + SM::ST);
  float* sD = sLse + BT;
  constexpr int LDT = SM::LDT;

  const Slice sl(a);
  const int k0 = blockIdx.x * BT, L = a.L, H = sl.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const float scale = a.scale;
  const float* qr = static_cast<const float*>(a.qr) + sl.rrow;
  const float* kr = static_cast<const float*>(a.kr) + sl.rrow;
  const float* v = static_cast<const float*>(a.v) + sl.bh;
  const float* dout = static_cast<const float*>(a.dout) + sl.orow;

  load_plain(sK, kr, k0, L, HD);
  load_plain(sV, v, k0, L, rs);

  Acc<float> dk, dv, acc;
  dk.zero();
  dv.zero();
  const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // previous query tile fully read
    load_plain(sQ, qr, q0, L, HD);
    load_plain(sDO, dout, q0, L, H * HD);
    load_stats_f32(sLse, sD, a, sl, q0);
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
      const float lse = sLse[row], delta = sD[row];
      const float p0 = okq && ok0 ? expf(sS[row * LDF + lane] * scale - lse) : 0.f;
      const float p1 = okq && ok1 ? expf(sS[row * LDF + lane + 32] * scale - lse) : 0.f;
      sP[row * LDT + lane] = p0;
      sP[row * LDT + lane + 32] = p1;
      sDS[row * LDT + lane] = p0 * (sDP[row * LDF + lane] - delta);
      sDS[row * LDT + lane + 32] = p1 * (sDP[row * LDF + lane + 32] - delta);
    }
    __syncthreads();  // the products below read every query row
    dv.atb(sP, sDO, warp, lane);   // dV[key][d] += sum_q P[q][key] dO[q][d]
    dk.atb(sDS, sQ, warp, lane);   // dK[key][d] += sum_q dS[q][key] Q[q][d]
  }
  __syncthreads();
  dv.store(sS, warp, lane);
  dk.store(sDP, warp, lane);
  __syncwarp();
  float* dk_out = static_cast<float*>(a.dk) + sl.bh;
  float* dv_out = static_cast<float*>(a.dv) + sl.bh;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, l = k0 + row;
    if (l < L) {
      write_row(dk_out + (size_t)l * rs, sDP + row * LDF, a.cos_t, a.sin_t, l, scale, true,
                lane);
      write_row(dv_out + (size_t)l * rs, sS + row * LDF, a.cos_t, a.sin_t, l, scale, false,
                lane);
    }
  }
}

// ---- bf16: register tiles on mma.sync ----------------------------------------

struct SmemBf16 {
  // dq: q, dO, K[2], V[2]; dkv: K, V, Q[2], dO[2], then lse[2][64] and
  // delta[2][64] f32
  static constexpr int STATS = 6 * tc::TILE_BYTES;
  static constexpr int BYTES = STATS + 4 * BT * 4;
};

__device__ __forceinline__ void bwd_dq_bf16(const Args& a) {
  using tc::bf16;
  using tc::TILE_ELEMS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + TILE_ELEMS;
  bf16* sK = sQ + 2 * TILE_ELEMS;  // two buffers
  bf16* sV = sQ + 4 * TILE_ELEMS;  // two buffers

  const Slice sl(a);
  const int q0 = blockIdx.x * BT, L = a.L, H = sl.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qr = static_cast<const bf16*>(a.qr) + sl.rrow;
  const bf16* kr = static_cast<const bf16*>(a.kr) + sl.rrow;
  const bf16* v = static_cast<const bf16*>(a.v) + sl.bh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + sl.orow;
  const int nk = (L + BT - 1) / BT;

  tc::load_tile(sQ, qr, q0, L, HD);
  tc::load_tile(sDO, dout, q0, L, H * HD);
  tc::load_tile(sK, kr, 0, L, HD);
  tc::load_tile(sV, v, 0, L, rs);
  tc::cp_async_commit();
  // rows g and g + 8 of this warp
  bool row_ok[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = q0 + warp * 16 + g + 8 * r;
    row_ok[r] = l < L;
    lse2[r] = row_ok[r] ? a.lse[sl.srow + l] * tc::LOG2E : 0.f;
    delta[r] = row_ok[r] ? a.delta[sl.srow + l] : 0.f;
  }
  tc::cp_async_wait_all();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  tc::load_a(qf, sQ, warp * 16, lane);
  tc::load_a(dof, sDO, warp * 16, lane);

  const float sl2 = a.scale * tc::LOG2E;
  float dq[8][4];
  tc::zero(dq);
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1, k0 = j * BT;
    const bf16* cK = sK + buf * TILE_ELEMS;
    const bf16* cV = sV + buf * TILE_ELEMS;
    if (j + 1 < nk) {  // the next tile's copy overlaps this tile's products
      tc::load_tile(sK + (buf ^ 1) * TILE_ELEMS, kr, k0 + BT, L, HD);
      tc::load_tile(sV + (buf ^ 1) * TILE_ELEMS, v, k0 + BT, L, rs);
      tc::cp_async_commit();
    }
    float s[8][4], dp[8][4];
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt(s, qf, cK, lane);    // S = q k^T
    tc::mma_abt(dp, dof, cV, lane);  // dP = dO v^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = row_ok[r] && k0 + 8 * n + 2 * t + (e & 1) < L;
        const float p = ok ? exp2f(s[n][e] * sl2 - lse2[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta[r]);  // dS
      }
    uint32_t dsf[4][4];
    tc::to_a(dsf, s);               // dS rounded to bf16
    tc::mma_ab(dq, dsf, cK, lane);  // dq += dS k
    if (j + 1 < nk) {
      tc::cp_async_wait_all();
      __syncthreads();  // the next tile landed; every warp is done with this one
    }
  }
  tc::scale_rotate_back(dq, a.cos_t, a.sin_t, q0 + warp * 16, L, a.scale, lane);
  const float one[2] = {1.f, 1.f};
  // sQ's rows of this warp were read only by this warp (load_a)
  tc::stage(sQ, warp * 16, dq, one, lane);
  __syncwarp();
  tc::store_rows16(static_cast<bf16*>(a.dq) + sl.bh, rs, sQ, warp * 16, q0 + warp * 16, L, lane);
}

// a query tile's lse and delta (rows >= L zero-filled), by cp.async
__device__ __forceinline__ void load_stats(float* s_lse, float* s_delta, const float* lse,
                                           const float* delta, int q0, int L) {
  const int i = threadIdx.x & 63, l = q0 + i;
  const bool ok = l < L;
  if (threadIdx.x < 64)
    tc::cp_async4(s_lse + i, ok ? lse + l : lse, ok);
  else if (threadIdx.x < 128)
    tc::cp_async4(s_delta + i, ok ? delta + l : delta, ok);
}

__device__ __forceinline__ void bwd_dkv_bf16(const Args& a) {
  using tc::bf16;
  using tc::TILE_ELEMS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE_ELEMS;
  bf16* sQ = sK + 2 * TILE_ELEMS;   // two buffers
  bf16* sDO = sK + 4 * TILE_ELEMS;  // two buffers
  float* sLse = reinterpret_cast<float*>(smem + SmemBf16::STATS);  // [2][64]
  float* sD = sLse + 2 * BT;                                       // [2][64]

  const Slice sl(a);
  const int k0 = blockIdx.x * BT, L = a.L, H = sl.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qr = static_cast<const bf16*>(a.qr) + sl.rrow;
  const bf16* kr = static_cast<const bf16*>(a.kr) + sl.rrow;
  const bf16* v = static_cast<const bf16*>(a.v) + sl.bh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + sl.orow;
  const float* lse = a.lse + sl.srow;
  const float* dlt = a.delta + sl.srow;
  const int nq = (L + BT - 1) / BT;

  tc::load_tile(sK, kr, k0, L, HD);
  tc::load_tile(sV, v, k0, L, rs);
  tc::load_tile(sQ, qr, 0, L, HD);
  tc::load_tile(sDO, dout, 0, L, H * HD);
  load_stats(sLse, sD, lse, dlt, 0, L);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  tc::load_a(kf, sK, warp * 16, lane);
  tc::load_a(vf, sV, warp * 16, lane);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + g + 8 * r < L;

  const float sl2 = a.scale * tc::LOG2E;
  float dk[8][4], dv[8][4];
  tc::zero(dk);
  tc::zero(dv);
  for (int i = 0; i < nq; ++i) {
    const int buf = i & 1, q0 = i * BT;
    const bf16* cQ = sQ + buf * TILE_ELEMS;
    const bf16* cDO = sDO + buf * TILE_ELEMS;
    const float* cLse = sLse + buf * BT;
    const float* cD = sD + buf * BT;
    if (i + 1 < nq) {
      tc::load_tile(sQ + (buf ^ 1) * TILE_ELEMS, qr, q0 + BT, L, HD);
      tc::load_tile(sDO + (buf ^ 1) * TILE_ELEMS, dout, q0 + BT, L, H * HD);
      load_stats(sLse + (buf ^ 1) * BT, sD + (buf ^ 1) * BT, lse, dlt, q0 + BT, L);
      tc::cp_async_commit();
    }
    float s[8][4], dp[8][4];
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt(s, kf, cQ, lane);    // S^T = k q^T: rows keys, columns queries
    tc::mma_abt(dp, vf, cDO, lane);  // dP^T = v dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(cLse + c);
      const float2 dl = *reinterpret_cast<const float2*>(cD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key_ok[e >> 1] && q0 + c + (e & 1) < L;
        const float p = ok ? exp2f(s[n][e] * sl2 - (e & 1 ? ls.y : ls.x) * tc::LOG2E) : 0.f;
        s[n][e] = p;                                        // P^T
        dp[n][e] = p * (dp[n][e] - (e & 1 ? dl.y : dl.x));  // dS^T
      }
    }
    uint32_t pf[4][4], dsf[4][4];
    tc::to_a(pf, s);
    tc::to_a(dsf, dp);
    tc::mma_ab(dv, pf, cDO, lane);  // dV += P^T dO
    tc::mma_ab(dk, dsf, cQ, lane);  // dK += dS^T q
    if (i + 1 < nq) {
      tc::cp_async_wait_all();
      __syncthreads();
    }
  }
  tc::scale_rotate_back(dk, a.cos_t, a.sin_t, k0 + warp * 16, L, a.scale, lane);
  const float one[2] = {1.f, 1.f};
  // the warp's rows of sK and sV were read only by this warp (load_a)
  tc::stage(sK, warp * 16, dk, one, lane);
  tc::stage(sV, warp * 16, dv, one, lane);
  __syncwarp();
  tc::store_rows16(static_cast<bf16*>(a.dk) + sl.bh, rs, sK, warp * 16, k0 + warp * 16, L, lane);
  tc::store_rows16(static_cast<bf16*>(a.dv) + sl.bh, rs, sV, warp * 16, k0 + warp * 16, L, lane);
}

// ---- bf16 on Hopper: TMA + mbarriers + wgmma ------------------------------

constexpr int TMA_MAX_TILES = 6;  // a head's walked pair held up to L = 384
constexpr int TMA_TILE = BT * 128;  // 64 rows of 128 bytes: 8 KB
constexpr int TMA_BARS = 128;       // the mbarriers' bytes
constexpr int PLAN_LEN = 38;        // the values of a plan
// No producer warp: thread 0 issues every copy when the block starts, and
// each SM sub-partition then holds two warps of a block, not three, so a
// thread may keep 255 registers (a ninth warp capped them at 168, and ptxas
// serialized the dkv pass's products for want of registers)
__host__ __device__ constexpr int tma_threads(int groups) { return 128 * groups; }

// The resident tiles of a block (every split-th of the head's), and its
// shared memory from the aligned base: the walked pair's 2 T tiles, two per
// resident tile, the head's lse (log2 units) and delta (T * 64 f32 each),
// the cos and sin tables (L * 32 f32 each: every rotation reads them from
// here, not from global memory), the mbarriers
__host__ __device__ constexpr int tma_res_tiles(int tiles, int split) {
  return (tiles + split - 1) / split;
}
__host__ __device__ constexpr int tma_stats_at(int tiles, int split) {
  return (2 * tiles + 2 * tma_res_tiles(tiles, split)) * TMA_TILE;
}
__host__ __device__ constexpr int tma_tables_at(int tiles, int split) {
  return tma_stats_at(tiles, split) + 2 * tiles * BT * 4;
}
__host__ __device__ constexpr int tma_bars_at(int tiles, int split, int L) {
  return tma_tables_at(tiles, split) + 2 * L * D2 * 4;
}
__host__ __device__ constexpr int tma_smem_bytes(int tiles, int split, int L) {
  return tma_bars_at(tiles, split, L) + TMA_BARS + wg::SMEM_SLACK;
}

struct TmaArgs {
  const float* lse;            // [B, H, L] f32, from the forward
  const float* delta;          // [B, H, L] f32, from the prologue
  tc::bf16 *dq, *dk, *dv;      // Layout `out`
  Layout out;
  const float *cos_t, *sin_t;  // [L, 32] f32
  int L, H, tiles;
  int col[3], head;            // q, k, v of head h at column col[i] + head * h of their maps
  float scale;
};

// Rotate the 64-row tile `tile` (128-byte swizzled, rows row0 + [0, 64)) in
// place, rows < L, with `threads` threads (thread `t` of them), tables cs and
// sn [L, 32] in shared memory; each pair as tc::rope_pair rounds it, then
// rounded to bf16. Rows past L stay TMA's zeros.
__device__ __forceinline__ void rotate_swizzled(unsigned char* tile, int row0, int L,
                                                const float* cs, const float* sn, int t,
                                                int threads) {
  using tc::bf16;
  for (int idx = t; idx < BT * 4; idx += threads) {
    const int r = idx >> 2, c0 = (idx & 3) * 8, l = row0 + r;
    if (l >= L) continue;
    uint4* lo = reinterpret_cast<uint4*>(tile + wg::swizzle128(r, c0));
    uint4* hi = reinterpret_cast<uint4*>(tile + wg::swizzle128(r, c0 + D2));
    uint4 x = *lo, y = *hi, u, v;
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ye = reinterpret_cast<const bf16*>(&y);
    bf16* ue = reinterpret_cast<bf16*>(&u);
    bf16* ve = reinterpret_cast<bf16*>(&v);
    const float4 c4[2] = {*reinterpret_cast<const float4*>(cs + l * D2 + c0),
                          *reinterpret_cast<const float4*>(cs + l * D2 + c0 + 4)};
    const float4 s4[2] = {*reinterpret_cast<const float4*>(sn + l * D2 + c0),
                          *reinterpret_cast<const float4*>(sn + l * D2 + c0 + 4)};
    const float* ce = reinterpret_cast<const float*>(c4);
    const float* se = reinterpret_cast<const float*>(s4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float2 q =
          tc::rope_pair(__bfloat162float(xe[e]), __bfloat162float(ye[e]), ce[e], se[e]);
      ue[e] = __float2bfloat16(q.x);
      ve[e] = __float2bfloat16(q.y);
    }
    *lo = u;
    *hi = v;
  }
}

// Scale an accumulator whose rows are sequence positions l0 + g and l0 + g +
// 8 and rotate it back by the inverse RoPE in f32, as tc::scale_rotate_back
// does, with the tables in shared memory
__device__ __forceinline__ void scale_rotate_back(float (&c)[8][4], const float* cs,
                                                  const float* sn, int l0, int L, float scale,
                                                  int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = l0 + g + 8 * half;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 co2 = *reinterpret_cast<const float2*>(cs + l * D2 + 8 * j + 2 * t);
      const float2 si2 = *reinterpret_cast<const float2*>(sn + l * D2 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float co = e ? co2.y : co2.x, si = e ? si2.y : si2.x;
        const float x = c[j][2 * half + e] * scale, y = c[j + 4][2 * half + e] * scale;
        c[j][2 * half + e] = x * co + y * si;
        c[j + 4][2 * half + e] = y * co - x * si;
      }
    }
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero: a
// P that small is 0 beside the gate (exp2f's subnormal handling made the
// passes' exponentials a third of their time)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving accesses of an A operand's registers across
// the asynchronous products that read them
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// acc = R W^T for a resident tile R and a walked tile W on the warpgroup, as
// one wgmma group (both operands K-major, from shared memory): S = R0 W0^T
// or dP = R1 W1^T. The accumulator is fenced before the wgmma fence and
// after the commit, so that no ordinary instruction defines it inside the
// products' stage (ptxas would serialize them).
__device__ __forceinline__ void issue_ss(float (&acc)[8][4], uint64_t dr,
                                         const unsigned char* w) {
  const uint64_t dw = wg::desc(w, 0, 1024);
  wg::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::mma_m64n64<0>(acc, wg::desc_add(dr, 32 * kk), wg::desc_add(dw, 32 * kk), kk > 0);
  wg::commit();
  wg::fence_acc(acc);
}

// S and dP of walked tile j, two groups (W1's tile waited for on its barrier)
__device__ __forceinline__ void issue_s_dp(float (&s)[8][4], float (&dp)[8][4], uint64_t dr0,
                                           uint64_t dr1, const unsigned char* w0,
                                           const unsigned char* w1, uint64_t* bar) {
  issue_ss(s, dr0, w0);
  wg::mbar_wait(bar, 0);
  issue_ss(dp, dr1, w1);
}

// acc = A W + (accumulate ? acc : 0), A [64, 64] bf16 from registers
// (tc::to_a), W a walked tile as the N-major operand, one wgmma group. The
// first walked tile starts the sum (accumulate 0) rather than zeroed
// registers: ptxas serializes the products whose accumulators ordinary
// instructions write.
__device__ __forceinline__ void issue_rs(float (&acc)[8][4], uint32_t (&a)[4][4],
                                         const unsigned char* w, int accumulate) {
  const uint64_t dw = wg::desc(w, TMA_TILE, 1024);
  wg::fence_acc(acc);
  fence_a(a);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::mma_m64n64_rs<1>(acc, a[kk], wg::desc_add(dw, 2048 * kk), kk > 0 || accumulate);
  wg::commit();
  wg::fence_acc(acc);
  fence_a(a);
}

// A warp's 16 rows of an accumulator, rounded to bf16, staged in its own rows
// of a resident tile (whose products are done) and written 16 bytes a lane to
// rows l = row0 + 16 wq + r < L of dst (row stride rs)
__device__ __forceinline__ void store_acc(unsigned char* tile, const float (&c)[8][4], int row0,
                                          int wq, int lane, int L, tc::bf16* dst, int rs) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + wg::swizzle128(16 * wq + g + 8 * hh, 8 * j + 2 * t4)) =
          tc::pack(c[j][2 * hh], c[j][2 * hh + 1]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, r = idx >> 3, ch = idx & 7, l = row0 + 16 * wq + r;
    if (l < L)
      *reinterpret_cast<uint4*>(dst + (size_t)l * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + wg::swizzle128(16 * wq + r, ch * 8));
  }
}

// P (P^T in the dkv pass) of the walked tile at rows c0 + [0, 64) from its
// scores s: exp2(S scale log2 e - lse log2 e), 0 where the thread's row or
// the column lies past L. lse by row (dq pass: lse2) or, in the dkv pass, by
// column from shared memory (sLse, log2 units)
template <bool DKV>
__device__ __forceinline__ void softmax_p(float (&p)[8][4], const float (&s)[8][4], int c0,
                                          const bool (&row_ok)[2], const float (&lse2)[2],
                                          const float* sLse, int L, float sl2, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = c0 + 8 * n + 2 * t4;
    float2 ls = make_float2(0.f, 0.f);
    if (DKV) ls = *reinterpret_cast<const float2*>(sLse + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = row_ok[r] && c + (e & 1) < L;
      const float l2 = DKV ? (e & 1 ? ls.y : ls.x) : lse2[r];
      p[n][e] = ok ? ex2(s[n][e] * sl2 - l2) : 0.f;
    }
  }
}

// dS = P (dP - delta) (dS^T in the dkv pass), rounded to bf16 as A fragments
// (tc::to_a's layout); delta by row (dlt) or by column from shared memory
template <bool DKV>
__device__ __forceinline__ void ds_frag(uint32_t (&dsf)[4][4], const float (&p)[8][4],
                                        const float (&dp)[8][4], int c0, const float (&dlt)[2],
                                        const float* sDel, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int n = 2 * kk + h2, c = c0 + 8 * n + 2 * t4;
      float2 dl = make_float2(0.f, 0.f);
      if (DKV) dl = *reinterpret_cast<const float2*>(sDel + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d0 = DKV ? dl.x : dlt[r], d1 = DKV ? dl.y : dlt[r];
        dsf[kk][2 * h2 + r] = tc::pack(p[n][2 * r] * (dp[n][2 * r] - d0),
                                       p[n][2 * r + 1] * (dp[n][2 * r + 1] - d1));
      }
    }
}

// One consumer warpgroup's resident tile (rows row0 + [0, 64): queries in
// the dq pass, keys in the dkv pass; R0 q or k, rotated here in place, R1 dO
// or v) over every walked tile (W0 the rotated K or Q, W1 V or dO). The
// score registers s and dp are written by the products alone, P and dS go
// to registers of their own: ptxas serializes products whose accumulators
// ordinary instructions write.
//   dq pass: two score buffers. Tile j + 1's S and dP are issued before tile
//     j's P and dS are worked out, so the tensor cores run them (and the
//     last dq product) while the warpgroup computes; then dq += dS K.
//   dkv pass (its four accumulators leave no room for a second buffer): S
//     and dP in their own groups, P once S lands, dV += P^T dO issued at
//     once, dS once dP lands, dK += dS^T Q, then the next tile's S and dP.
template <bool DKV>
__device__ __forceinline__ void bwd_tile(const TmaArgs& a, const unsigned char* sW0,
                                         const unsigned char* sW1, unsigned char* r0t,
                                         unsigned char* r1t, uint64_t* rbar, uint64_t* w1bar,
                                         const float* sLse, const float* sDel, const float* cs,
                                         const float* sn, int row0, int b, int h, int grp,
                                         int wq, int lane, float sl2) {
  const int T = a.tiles, L = a.L, g = lane >> 2, t4 = lane & 3;
  // rows g and g + 8 of this warp; in the dq pass their lse (log2 units) and delta
  bool row_ok[2];
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = row0 + 16 * wq + g + 8 * r;
    row_ok[r] = l < L;
    if (!DKV) {
      lse2[r] = sLse[l];
      dlt[r] = sDel[l];
    }
  }
  wg::mbar_wait(rbar, 0);
  rotate_swizzled(r0t, row0, L, cs, sn, threadIdx.x % 128, 128);
  wg::fence_proxy();  // R0, rewritten by threads, is read by wgmma
  wg::bar_sync(2 + grp, 128);
  const uint64_t dr0 = wg::desc(r0t, 0, 1024), dr1 = wg::desc(r1t, 0, 1024);
  float acc0[8][4], acc1[8][4];  // dq (dq pass); dk and dv (dkv pass), begun by tile 0
  float s[8][4], dp[8][4], p[8][4];
  uint32_t dsf[4][4];
  issue_s_dp(s, dp, dr0, dr1, sW0, sW1, &w1bar[0]);
  if (!DKV) {
    float s2[8][4], dp2[8][4];
    // tile j from (cur_s, cur_dp), tile j + 1's products into (nxt_s, nxt_dp)
    auto step = [&](int j, float (&cur_s)[8][4], float (&cur_dp)[8][4], float (&nxt_s)[8][4],
                    float (&nxt_dp)[8][4]) {
      const unsigned char* w0 = sW0 + j * TMA_TILE;
      if (j + 1 < T) {
        issue_s_dp(nxt_s, nxt_dp, dr0, dr1, w0 + TMA_TILE, sW1 + (j + 1) * TMA_TILE,
                   &w1bar[j + 1]);
        wg::wait<2>();  // tile j's S and dP (and the last dq product) landed
      } else {
        wg::wait<0>();
      }
      wg::fence_acc(cur_s);
      wg::fence_acc(cur_dp);
      softmax_p<false>(p, cur_s, BT * j, row_ok, lse2, sLse, L, sl2, t4);
      ds_frag<false>(dsf, p, cur_dp, BT * j, dlt, sDel, t4);
      issue_rs(acc0, dsf, w0, j > 0);  // dq += dS K
    };
    for (int j = 0; j < T; j += 2) {
      step(j, s, dp, s2, dp2);
      if (j + 1 < T) step(j + 1, s2, dp2, s, dp);
    }
  } else {
    uint32_t pf[4][4];
    for (int j = 0; j < T; ++j) {
      const unsigned char* w0 = sW0 + j * TMA_TILE;
      wg::wait<1>();  // S of this tile (and the last tile's products) landed
      wg::fence_acc(s);
      softmax_p<true>(p, s, BT * j, row_ok, lse2, sLse, L, sl2, t4);
      tc::to_a(pf, p);
      issue_rs(acc1, pf, sW1 + j * TMA_TILE, j > 0);  // dV += P^T dO, under the wait for dP
      wg::wait<1>();
      wg::fence_acc(dp);
      ds_frag<true>(dsf, p, dp, BT * j, dlt, sDel, t4);
      issue_rs(acc0, dsf, w0, j > 0);  // dK += dS^T Q
      if (j + 1 < T)
        issue_s_dp(s, dp, dr0, dr1, w0 + TMA_TILE, sW1 + (j + 1) * TMA_TILE, &w1bar[j + 1]);
    }
  }
  wg::wait<0>();
  wg::fence_acc(acc0);
  if (DKV) wg::fence_acc(acc1);
  // dq or dk scaled and rotated back in f32, then rounded; dv as summed
  scale_rotate_back(acc0, cs, sn, row0 + 16 * wq, L, a.scale, lane);
  const size_t at = a.out.at(b, h);
  store_acc(r0t, acc0, row0, wq, lane, L, (DKV ? a.dk : a.dq) + at, a.out.row);
  if (DKV) store_acc(r1t, acc1, row0, wq, lane, L, a.dv + at, a.out.row);
}

// Block x of a head's `split` blocks takes (head h, row b) and the resident
// tiles x, x + split, ...: thread 0 TMA-loads the GROUPS warpgroups' first
// resident pairs, then the head's whole walked pair, then the block's other
// resident pairs, all at once (with DKV every thread then loads part of the
// head's lse, in log2 units, and delta into shared memory, zero past L). The
// walked W0 tiles land on one mbarrier and the warpgroups rotate them in
// place together, once for the block; each W1 tile and each resident pair
// has its own. The warpgroups then take the resident tiles in turn. Maps over q, k,
// v ([B][L][width]: the merged qkv for K3, three tensors for K6) and dO
// ([B][L][H 64]); boxes 64 x 64, 128-byte swizzle, zeros past L.
template <bool DKV, int GROUPS>
__device__ __forceinline__ void wgmma_bwd(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap, const CUtensorMap* omap,
                                          const TmaArgs& a) {
  unsigned char* smem = wg::aligned_smem();
  const int T = a.tiles, L = a.L, h = blockIdx.y, b = blockIdx.z;
  const int split = gridDim.x, x = blockIdx.x, nr = (T - x + split - 1) / split;
  const int R = tma_res_tiles(T, split);
  unsigned char* sW0 = smem;                     // walked K (dq) or Q (dkv), rotated
  unsigned char* sW1 = smem + T * TMA_TILE;      // walked V (dq) or dO (dkv)
  unsigned char* sR0 = smem + 2 * T * TMA_TILE;  // slot i: q (dq) or k (dkv) of tile x + split i
  unsigned char* sR1 = sR0 + R * TMA_TILE;       // slot i: dO (dq) or v (dkv)
  float* sLse = reinterpret_cast<float*>(smem + tma_stats_at(T, split));
  float* sDel = sLse + T * BT;
  float* cs = reinterpret_cast<float*>(smem + tma_tables_at(T, split));
  float* sn = cs + L * D2;
  uint64_t* w0bar = reinterpret_cast<uint64_t*>(smem + tma_bars_at(T, split, L));
  uint64_t* tbar = w0bar + 1;
  uint64_t* w1bar = tbar + 1;
  uint64_t* rbar = w1bar + T;
  if (threadIdx.x == 0) {
    wg::mbar_init(w0bar, 1);
    wg::mbar_init(tbar, 1);
    for (int j = 0; j < T; ++j) wg::mbar_init(&w1bar[j], 1);
    for (int i = 0; i < nr; ++i) wg::mbar_init(&rbar[i], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // every copy, at once
    const int qc = a.col[0] + a.head * h, kc = a.col[1] + a.head * h;
    const int vc = a.col[2] + a.head * h, oc = HD * h;
    const CUtensorMap* r0map = DKV ? kmap : qmap;
    const CUtensorMap* r1map = DKV ? vmap : omap;
    const CUtensorMap* w0map = DKV ? qmap : kmap;
    const CUtensorMap* w1map = DKV ? omap : vmap;
    const int r0c = DKV ? kc : qc, r1c = DKV ? vc : oc, w0c = DKV ? qc : kc, w1c = DKV ? oc : vc;
    for (const CUtensorMap* m : {qmap, kmap, vmap, omap}) wg::tma_prefetch(m);
    wg::mbar_arrive_expect(tbar, 2 * L * D2 * 4);  // the tables first: every rotation needs them
    wg::bulk_load(cs, a.cos_t, L * D2 * 4, tbar);
    wg::bulk_load(sn, a.sin_t, L * D2 * 4, tbar);
    const int first = nr < GROUPS ? nr : GROUPS;
    for (int pass = 0; pass < 2; ++pass)  // the first resident pairs, later the rest
      for (int i = pass ? first : 0; i < (pass ? nr : first); ++i) {
        const int r0 = BT * (x + split * i);
        wg::mbar_arrive_expect(&rbar[i], 2 * TMA_TILE);
        wg::tma_load_3d(sR0 + i * TMA_TILE, r0map, &rbar[i], r0c, r0, b);
        wg::tma_load_3d(sR1 + i * TMA_TILE, r1map, &rbar[i], r1c, r0, b);
        if (pass == 0 && i == first - 1) {  // the walked pair
          wg::mbar_arrive_expect(w0bar, T * TMA_TILE);
          for (int j = 0; j < T; ++j)
            wg::tma_load_3d(sW0 + j * TMA_TILE, w0map, w0bar, w0c, BT * j, b);
          for (int j = 0; j < T; ++j) {
            wg::mbar_arrive_expect(&w1bar[j], TMA_TILE);
            wg::tma_load_3d(sW1 + j * TMA_TILE, w1map, &w1bar[j], w1c, BT * j, b);
          }
        }
      }
  }
  {  // the head's lse (log2 units) and delta, zero past L
    const float* lse = a.lse + ((size_t)b * a.H + h) * L;
    const float* dl = a.delta + ((size_t)b * a.H + h) * L;
    for (int i = threadIdx.x; i < T * BT; i += 128 * GROUPS) {
      const bool ok = i < L;
      sLse[i] = ok ? __ldg(lse + i) * tc::LOG2E : 0.f;
      sDel[i] = ok ? __ldg(dl + i) : 0.f;
    }
  }

  // the walked W0 rotated in place once, by every thread; the barrier also
  // publishes the statistics
  wg::mbar_wait(tbar, 0);
  wg::mbar_wait(w0bar, 0);
  for (int j = 0; j < T; ++j)
    rotate_swizzled(sW0 + j * TMA_TILE, BT * j, L, cs, sn, threadIdx.x, 128 * GROUPS);
  wg::fence_proxy();
  wg::bar_sync(1, 128 * GROUPS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, grp = warp / 4, wq = warp % 4;
  const float sl2 = a.scale * tc::LOG2E;
  for (int i = grp; i < nr; i += GROUPS)
    bwd_tile<DKV>(a, sW0, sW1, sR0 + i * TMA_TILE, sR1 + i * TMA_TILE, &rbar[i], w1bar, sLse,
                  sDel, cs, sn, BT * (x + split * i), b, h, grp, wq, lane, sl2);
}

// K3's and K6's Hopper kernels, with GROUPS consumer warpgroups: one body,
// two names each
#define HD_BWD_KERNEL(NAME, DKV)                                                           \
  template <int GROUPS>                                                                    \
  __global__ void __launch_bounds__(tma_threads(GROUPS), GROUPS == 1 ? 2 : 1)              \
      NAME(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap, \
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap, \
           TmaArgs a) {                                                                    \
    wgmma_bwd<DKV, GROUPS>(&qmap, &kmap, &vmap, &omap, a);                                 \
  }
HD_BWD_KERNEL(wgmma_rope_attention_bwd_dq_kernel, false)
HD_BWD_KERNEL(wgmma_rope_attention_bwd_dkv_kernel, true)
HD_BWD_KERNEL(wgmma_rope_attention_sep_bwd_dq_kernel, false)
HD_BWD_KERNEL(wgmma_rope_attention_sep_bwd_dkv_kernel, true)
#undef HD_BWD_KERNEL

template <typename T>
__device__ __forceinline__ void bwd_dq(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    bwd_dq_f32(a);
  else
    bwd_dq_bf16(a);
}
template <typename T>
__device__ __forceinline__ void bwd_dkv(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    bwd_dkv_f32(a);
  else
    bwd_dkv_bf16(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_prep_kernel(Args a) {
  bwd_prep<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_dq_kernel(Args a) {
  bwd_dq<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_dkv_kernel(Args a) {
  bwd_dkv<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_bwd_prep_kernel(Args a) {
  bwd_prep<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_bwd_dq_kernel(Args a) {
  bwd_dq<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_bwd_dkv_kernel(Args a) {
  bwd_dkv<T>(a);
}

template <typename T, void (*PREP)(Args), void (*DQ)(Args), void (*DKV)(Args)>
int launch(const Args& a, int B, int H, cudaStream_t stream, int* launched) {
  constexpr int bytes = std::is_same<T, float>::value ? SmemF32::BYTES : SmemBf16::BYTES;
  // set once per instantiation: the port drives one card per process
  static const cudaError_t a1 =
      cudaFuncSetAttribute(DQ, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t a2 =
      cudaFuncSetAttribute(DKV, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const dim3 grid((a.L + BT - 1) / BT, H, B);
  cudaError_t err;
  PREP<<<grid, THREADS, 0, stream>>>(a);  // the scratch and delta the passes read
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  DQ<<<grid, THREADS, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  DKV<<<grid, THREADS, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// The Hopper path's three launches: the bf16 prologue (delta alone: `a`
// has no scratch), then the dq and dkv passes on the plan's grid with GROUPS
// consumer warpgroups.
// q, k, v are maps over `qkv` (K3: one tensor, q, k, v of head h at columns
// 192 h + 0, 64, 128) or over q, k, v (K6: 64 h each), `width` columns a
// row. The plan must be this entry's own for the shape (the caller's
// ops/fused_attention.py::rope_attention_bwd_plan, PLAN_LEN values): grid
// (split, H, B), threads, the passes' shared memory, tiles, then the maps
// of q, k, v and dO (dims 3, byte strides 2, box 3 each). cos and sin must
// be 16-byte aligned (one bulk copy each).
template <bool SEP, int GROUPS>
int launch_tma(const Args& a, const void* const (&qkv)[3], long long width, int B, int H,
               const long long* plan, cudaStream_t stream, int* launched) {
  const int L = a.L, tiles = (L + BT - 1) / BT;
  const long long split = plan[0], o = (long long)H * HD;
  if (split < 1 || split > tiles || tiles > TMA_MAX_TILES) return (int)cudaErrorInvalidValue;
  long long want[PLAN_LEN] = {split, H, B, tma_threads(GROUPS),
                              tma_smem_bytes(tiles, (int)split, L), tiles};
  for (int m = 0; m < 4; ++m) {
    const long long w = m < 3 ? width : o;
    const long long map[8] = {w, L, B, w * 2, L * w * 2, HD, BT, 1};
    for (int i = 0; i < 8; ++i) want[6 + 8 * m + i] = map[i];
  }
  for (int i = 0; i < PLAN_LEN; ++i)
    if (plan[i] != want[i]) return (int)cudaErrorInvalidValue;
  if (want[4] > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const void* bases[4] = {qkv[0], qkv[1], qkv[2], a.dout};
  for (const void* p : {bases[0], bases[1], bases[2], bases[3], (const void*)a.cos_t,
                        (const void*)a.sin_t})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  // the limit, set once for the instantiation's two kernels: the port drives
  // one card per process
  static const cudaError_t attr = [] {
    const void* dq = SEP ? (const void*)wgmma_rope_attention_sep_bwd_dq_kernel<GROUPS>
                         : (const void*)wgmma_rope_attention_bwd_dq_kernel<GROUPS>;
    const void* dkv = SEP ? (const void*)wgmma_rope_attention_sep_bwd_dkv_kernel<GROUPS>
                          : (const void*)wgmma_rope_attention_bwd_dkv_kernel<GROUPS>;
    const cudaError_t e =
        cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[4];
  for (int m = 0; m < 4; ++m) {
    const long long* p = plan + 6 + 8 * m;
    const cuuint64_t dims[3] = {(cuuint64_t)p[0], (cuuint64_t)p[1], (cuuint64_t)p[2]};
    const cuuint64_t strides[2] = {(cuuint64_t)p[3], (cuuint64_t)p[4]};
    const cuuint32_t box[3] = {(cuuint32_t)p[5], (cuuint32_t)p[6], (cuuint32_t)p[7]};
    if (!wg::encode(&maps[m], bases[m], 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  const int head = SEP ? HD : 3 * HD;
  const TmaArgs t{a.lse, a.delta, static_cast<tc::bf16*>(a.dq), static_cast<tc::bf16*>(a.dk),
                  static_cast<tc::bf16*>(a.dv), a.in, a.cos_t, a.sin_t, L, H, tiles,
                  {0, SEP ? 0 : HD, SEP ? 0 : 2 * HD}, head, a.scale};
  cudaError_t err;  // the prologue: delta alone (a.qr null), the passes rotate q and k
  if (SEP)
    rope_attention_sep_bwd_prep_kernel<__nv_bfloat16><<<dim3(tiles, H, B), THREADS, 0, stream>>>(a);
  else
    rope_attention_bwd_prep_kernel<__nv_bfloat16><<<dim3(tiles, H, B), THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const dim3 grid((unsigned)plan[0], (unsigned)plan[1], (unsigned)plan[2]);
  const int threads = tma_threads(GROUPS);
  if (SEP)
    wgmma_rope_attention_sep_bwd_dq_kernel<GROUPS><<<grid, threads, (int)plan[4], stream>>>(
        maps[0], maps[1], maps[2], maps[3], t);
  else
    wgmma_rope_attention_bwd_dq_kernel<GROUPS><<<grid, threads, (int)plan[4], stream>>>(
        maps[0], maps[1], maps[2], maps[3], t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  if (SEP)
    wgmma_rope_attention_sep_bwd_dkv_kernel<GROUPS><<<grid, threads, (int)plan[4], stream>>>(
        maps[0], maps[1], maps[2], maps[3], t);
  else
    wgmma_rope_attention_bwd_dkv_kernel<GROUPS><<<grid, threads, (int)plan[4], stream>>>(
        maps[0], maps[1], maps[2], maps[3], t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// launch_tma for the plan's consumer warpgroups (its threads: 1 or 2 groups)
template <bool SEP>
int launch_tma_groups(const Args& a, const void* const (&qkv)[3], long long width, int B, int H,
                      const long long* plan, cudaStream_t stream, int* launched) {
  if (plan[3] == tma_threads(1))
    return launch_tma<SEP, 1>(a, qkv, width, B, H, plan, stream, launched);
  if (plan[3] == tma_threads(2))
    return launch_tma<SEP, 2>(a, qkv, width, B, H, plan, stream, launched);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int B, int L, int H, int head_dim) {
  return head_dim != HD || B <= 0 || L <= 0 || H <= 0 || H > 65535 || B > 65535;
}

}  // namespace

// qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, dout [B, L, H*64] in
// qkv's type; the forward's residuals out_f32 [B, L, H*64] f32 (its output
// before rounding) and lse [B, H, L] f32; dqkv [B, L, H*3*64] out; scratch:
// rot [2, B, H, L, 64] in qkv's type and delta [B, H, L] f32. dtype 0 =
// float32, 1 = bfloat16. Sets *launched to the number of kernels launched (3
// on success) and returns a cudaError_t code (0 = launched).
extern "C" int hd_rope_attention_qkv_bwd(const void* qkv, const void* cos_t,
                                         const void* sin_t, const void* dout,
                                         const void* out_f32, const void* lse, void* dqkv,
                                         void* rot, void* delta, int B, int L, int H,
                                         int head_dim, float scale, int dtype, void* stream,
                                         int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const char* in = static_cast<const char*>(qkv);
  char* g = static_cast<char*>(dqkv);
  char* r = static_cast<char*>(rot);
  const Args a{in, in + HD * es, in + 2 * HD * es, dout, static_cast<const float*>(out_f32),
               static_cast<const float*>(lse), r, r + (size_t)B * H * L * HD * es,
               static_cast<float*>(delta), g, g + HD * es, g + 2 * HD * es,
               Layout{L * 3 * H * HD, 3 * H * HD, 3 * HD}, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, rope_attention_bwd_prep_kernel<float>,
                  rope_attention_bwd_dq_kernel<float>, rope_attention_bwd_dkv_kernel<float>>(
        a, B, H, s, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_bwd_prep_kernel<__nv_bfloat16>,
                  rope_attention_bwd_dq_kernel<__nv_bfloat16>,
                  rope_attention_bwd_dkv_kernel<__nv_bfloat16>>(a, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

// K6: q, k, v, dout [B, L, H*64], out_f32 and lse as above, dq, dk, dv
// [B, L, H*64] out, the scratch and the rest as above.
extern "C" int hd_rope_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* cos_t, const void* sin_t, const void* dout,
                                     const void* out_f32, const void* lse, void* dq, void* dk,
                                     void* dv, void* rot, void* delta, int B, int L, int H,
                                     int head_dim, float scale, int dtype, void* stream,
                                     int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  char* r = static_cast<char*>(rot);
  const Args a{q, k, v, dout, static_cast<const float*>(out_f32),
               static_cast<const float*>(lse), r, r + (size_t)B * H * L * HD * es,
               static_cast<float*>(delta), dq, dk, dv, Layout{L * H * HD, H * HD, HD},
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, rope_attention_sep_bwd_prep_kernel<float>,
                  rope_attention_sep_bwd_dq_kernel<float>,
                  rope_attention_sep_bwd_dkv_kernel<float>>(a, B, H, s, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_sep_bwd_prep_kernel<__nv_bfloat16>,
                  rope_attention_sep_bwd_dq_kernel<__nv_bfloat16>,
                  rope_attention_sep_bwd_dkv_kernel<__nv_bfloat16>>(a, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

// K3 on Hopper (bf16, L <= 384): the arguments of hd_rope_attention_qkv_bwd
// with dtype bf16 and no scratch but delta, qkv and dout at 16-byte aligned
// addresses, and `plan` the launch the caller computed (see launch_tma); a
// plan other than this entry's own for the shape is refused. Sets
// *launched (3 on success) and returns a cudaError_t code.
extern "C" int hd_rope_attention_qkv_bwd_tma(const void* qkv, const void* cos_t,
                                             const void* sin_t, const void* dout,
                                             const void* out_f32, const void* lse, void* dqkv,
                                             void* delta, int B, int L, int H, float scale,
                                             const long long* plan, void* stream,
                                             int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, HD)) return (int)cudaErrorInvalidValue;
  constexpr int es = 2;
  const char* in = static_cast<const char*>(qkv);
  char* g = static_cast<char*>(dqkv);
  const Args a{in, in + HD * es, in + 2 * HD * es, dout, static_cast<const float*>(out_f32),
               static_cast<const float*>(lse), nullptr, nullptr, static_cast<float*>(delta), g,
               g + HD * es, g + 2 * HD * es, Layout{L * 3 * H * HD, 3 * H * HD, 3 * HD},
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, scale};
  const void* const bases[3] = {qkv, qkv, qkv};
  return launch_tma_groups<false>(a, bases, 3LL * H * HD, B, H, plan,
                                  static_cast<cudaStream_t>(stream), launched);
}

// K6 on Hopper: the arguments of hd_rope_attention_bwd with dtype bf16 and no
// scratch but delta, q, k, v and dout at 16-byte aligned addresses, and
// `plan` as above.
extern "C" int hd_rope_attention_bwd_tma(const void* q, const void* k, const void* v,
                                         const void* cos_t, const void* sin_t, const void* dout,
                                         const void* out_f32, const void* lse, void* dq,
                                         void* dk, void* dv, void* delta, int B, int L, int H,
                                         float scale, const long long* plan, void* stream,
                                         int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, HD)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(out_f32),
               static_cast<const float*>(lse), nullptr, nullptr, static_cast<float*>(delta), dq,
               dk, dv, Layout{L * H * HD, H * HD, HD}, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), L, scale};
  const void* const bases[3] = {q, k, v};
  return launch_tma_groups<true>(a, bases, (long long)H * HD, B, H, plan,
                                 static_cast<cudaStream_t>(stream), launched);
}
