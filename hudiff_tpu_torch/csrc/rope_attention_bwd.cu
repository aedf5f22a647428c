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
// seven products (S and dP in both passes), 77.7 GFLOP.
//
// Design, bf16 (FlashAttention-2's deterministic backward on mma.sync;
// csrc/mma_tiles.cuh). Hopper blocks cannot carry dK, dV across a grid, so
// two passes after a prologue, with no atomics and the same bits every run:
//   (p) one block per (b, h, 64 rows) rotates q and k once into a
//       head-contiguous [B, H, L, 64] scratch in T and takes delta =
//       rowsum(dO * out_f32) in f32. (An earlier version of this body
//       rotated each landed tile in shared memory, two barriers a tile and
//       every tile rotated once per block, and summed delta in a second
//       walk of the dq pass: 0.89 ms at B=128 against this design's 0.61,
//       chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W.)
//   (dq) one block per (b, h, 64 queries) holds its rotated q and dO rows as
//       A fragments in registers and walks the key tiles once: S = q k^T,
//       dP = dO v^T, P = exp2(S scale log2e - lse log2e), dS = P (dP -
//       delta) re-packed as bf16 A fragments, dq += dS k;
//   (dkv) one block per (b, h, 64 keys) holds its rotated k and v rows as A
//       fragments and walks the query tiles once: S^T = k q^T, dP^T = v dO^T,
//       P^T and dS^T in registers from the tile's lse and delta,
//       dV += P^T dO, dK += dS^T q (ldmatrix.trans reads dO and q as the B
//       operands).
// Every S, P, dP and dS stays in registers; tiles arrive by cp.async into a
// double buffer, one barrier a tile. dq and dk are scaled and rotated back in
// registers (column c and c + 32 of a row sit in the same thread), staged
// through a free tile and written 16 bytes a lane. Keys and queries >= L get
// P = 0 explicitly; rows >= L are never written. f32 (the tests' reference
// type, and the f32 card-vs-CPU train step) keeps the exact FMA path of
// attention_tiles.cuh on the same prologue and residuals. K3's kernels are
// rope_attention_bwd_{prep,dq,dkv}_kernel, K6's
// rope_attention_sep_bwd_{prep,dq,dkv}_kernel: one body, two names.

#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

using namespace hd;

namespace {

constexpr int BT = 64;       // queries or keys per tile

struct Args {
  const void *q, *k, *v;    // Layout `in`; q and k are read by the prologue only
  const void* dout;         // [B, L, H*64]
  const float* out_f32;     // [B, L, H*64] f32, the forward's unrounded output
  const float* lse;         // [B, H, L] f32, from the forward
  void *qr, *kr;            // [B, H, L, 64] T scratch: T(rope(q)), T(rope(k))
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
// into the head-contiguous scratch, and delta = rowsum(dO * out_f32) in f32.
template <typename T>
__device__ __forceinline__ void bwd_prep(const Args& a) {
  constexpr int V = Cfg<T>::VEC;  // elements in 16 bytes
  constexpr int ITEMS = BT * (D2 / V);
  const Slice sl(a);
  const int r0 = blockIdx.x * BT, L = a.L, H = sl.H;
  for (int idx = threadIdx.x; idx < 2 * ITEMS; idx += THREADS) {
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
  // row r0 + tid / 2, half a row a thread
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, l = r0 + r;
  float d = 0.f;
  if (l < L) {
    const size_t off = sl.orow + (size_t)l * H * HD + half * D2;
    const T* dp = static_cast<const T*>(a.dout) + off;
    const float* op = a.out_f32 + off;
#pragma unroll
    for (int c = 0; c < D2; c += V) {
      Pack<T> g;
      g.u = __ldg(reinterpret_cast<const uint4*>(dp + c));
#pragma unroll
      for (int e = 0; e < V; ++e) d += to_f(g[e]) * op[c + e];
    }
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
