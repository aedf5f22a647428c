// K1, K5 and K7: one hand-written attention forward, instantiated for each
// layout, in two designs: Hopper's TMA + wgmma and sm_80's mma.sync.
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
// Layout: on the mma.sync and FMA paths each operand is reached through a
// base pointer and a Layout (batch stride, row stride, per-head offset); q,
// k and v share one, out has its own. K1 points q, k, v at columns 0, 64,
// 128 of the merged qkv. The Hopper path reads q, k and v through tensor
// maps (below) and writes out through a Layout.
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): bytes. At B=64, L=291, bf16 one K1 call reads the 57 MB qkv block
// and writes 19 MB, about 23 us at 3.35 TB/s, against 11 GFLOP (11 us at
// 989 TFLOP/s) of tensor-core work; K5 and K7 move the same bytes. At the
// sampler's B=16 a call is 5.7 us of bytes, and what costs is the chain of
// dependent steps a block runs: load, rotate, then per key tile a product,
// the softmax and a second product.
//
// K1, K5 and K7 in bf16 at L <= 384 with 64 or more (b, h) pairs, on
// Hopper (wgmma_tiles.cuh): one body, wgmma_attention_fwd<ROPE, RES>, as
// wgmma_rope_attention_qkv_kernel (K1), wgmma_rope_attention_sep_fwd_kernel
// (K5) and wgmma_plain_attention_kernel (K7, no rotation, no residuals), in
// place of the mma.sync design below for them. A block takes (head h, row b)
// and every split-th of the head's query tiles (ops/fused_attention.py::
// rope_attention_qkv_plan, one plan for the four layouts: 2 blocks a head at
// L = 291, 1 or 2 at 152). Thread 0 TMA-loads the block's q tiles and the
// head's whole K and V at once, each tile on its own mbarrier (K on one),
// into 128-byte-swizzled shared memory: at L = 291 K and V are 80 KB, and
// nothing waits on a copy but its first use. q, k and v come through three
// 3-D tensor maps, boxes of 64 rows by 64 columns, rows past L as TMA's
// zeros: K1 one map over qkv [B][L][H*192] at columns 192h, +64, +128; K5
// and K7's [B, L, H, 64] maps over q, k, v [B][L][H*64] at column 64h; K7's
// [B, H, L, 64] maps over [B*H][L][64] at row b*H + h. With the rotation
// (K1, K5) the two warpgroups rotate K in place together, once for the
// block (the mma.sync design rotates every K tile again in each of a head's
// five blocks), and each q tile in place on arrival; K7's tiles go to wgmma
// as TMA wrote them. Then the warpgroups take the q tiles in turn and run
// the online softmax on wgmma, S = q k^T from shared memory (both operands
// K-major), S and P in registers, O += P V with P as register A fragments
// (V the N-major operand), keys >= L at P = 0. The output is staged in the
// q tile and written 16 bytes a lane at the layout's strides. A block is
// the two warpgroups alone: a ninth (producer) warp made ptxas allot
// registers as for ten warps, 96 a thread at two blocks an SM, where it
// spilled and serialized wgmma; without it a block uses at most 128
// registers (140 with the residuals, one block an SM). Why no cluster
// multicast of K and V: a head's blocks each read its 80 KB of K and V from
// L2 once, against a chain of dependent steps many times longer; splitting
// a head's query tiles over two blocks halves the chain a block waits on
// and puts 256 blocks on the 132 SMs at B = 16, and a second block on an SM
// hides the rest. chip_smoke.py times every split (K1's device_ms_by_split);
// two read fastest at L = 291 on an H100 (PERF.md).
//
// The other instantiations keep the mma.sync design (bf16 FlashAttention-2 on
// mma.sync; csrc/mma_tiles.cuh): the [291, 291] f32 score block (339 KB)
// does not fit a block's 227 KB, so one block of four warps takes (b, h, 64
// queries) and walks the keys in tiles of 64 with an online softmax. The q
// tile is rotated once in shared memory and held as A fragments in
// registers. K/V tiles arrive by cp.async into a double buffer (the next
// tile's copy overlaps this tile's products); a landed k tile is rotated
// in place. Each warp keeps its 16 rows of S, P and O in registers: S = q
// k^T by m16n8k16 products, the row max and sum by quad shuffles (exp2 of
// scaled log2 scores), P re-packed as bf16 A fragments for O += P V, O
// rescaled in registers. Keys >= L get P = 0 explicitly; rows >= L are
// never stored. Each query tile reads its head's K/V again; the repeats hit
// L2. K1, K5 and K7 past L = 384 or below 64 (b, h) pairs take it.
// The residual instantiations (both designs) split P into bf16(P) and the
// rest, which rounding dropped, and accumulate (P - bf16(P)) V as a second
// product, so that out_f32 = (P v)/l carries P to ~2^-16; one more product
// per tile.
// f32 (the tests' reference type) keeps the exact FMA path of
// attention_tiles.cuh: S and O in f32 shared tiles, one warp reduction per
// row. The instantiations have their own kernel names, so a profiler tells
// them apart.

#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

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

// ---- bf16 K1, K5 and K7 on Hopper: TMA + wgmma -------------------------------

constexpr int TMA_GROUPS = 2;                          // consumer warpgroups a block
constexpr int TMA_THREADS = 4 * TMA_GROUPS * 32;        // thread 0 issues every copy
constexpr int TMA_TILE = BKV * 128;                    // 64 rows of 128 bytes: 8 KB
constexpr int TMA_MAX_TILES = 6;                       // K and V held up to L = 384
constexpr int TMA_BARS = 128;                          // the mbarriers' bytes
constexpr int TMA_PLAN_LEN = 14;                       // the values of a plan

// Shared memory from the aligned base: K tiles, V tiles, the block's q tiles
// (every split-th of the head's), the mbarriers (K, one per q tile, one per
// V tile)
__host__ __device__ constexpr int tma_q_tiles(int kv_tiles, int split) {
  return (kv_tiles + split - 1) / split;
}
__host__ __device__ constexpr int tma_smem_bytes(int kv_tiles, int split) {
  return (2 * kv_tiles + tma_q_tiles(kv_tiles, split)) * TMA_TILE + TMA_BARS + wg::SMEM_SLACK;
}

// Where the operands lie. q, k and v are read through three tensor maps (K1:
// one map over qkv, three times): head h of batch row b at column col[m] +
// head * h of map m, at outer coordinate b (zh 0: maps over [B][L][width])
// or b H + h (zh 1: K7's [B H][L][64]). out and out_f32 at o.at(b, h) +
// row * o.row.
struct TmaArgs {
  tc::bf16* out;
  float* lse;                  // [B, H, L] f32, or nullptr (then out_f32 too)
  float* out_f32;              // f32, out's layout
  Layout o;
  const float *cos_t, *sin_t;  // [L, 32] f32 (ROPE only)
  int L, H, kv_tiles;
  int col[3], head, zh;
  float scale;
};

// One consumer warpgroup's query tile (rows row0 + [0, 64), landed at tq on
// qbar) over the held K (rotated when ROPE) and V: the output rows (and with
// RES the residuals) written
template <bool ROPE, bool RES>
__device__ __forceinline__ void attend_tile(const TmaArgs& a, const unsigned char* sK,
                                            const unsigned char* sV, unsigned char* tq,
                                            uint64_t* qbar, uint64_t* vbar, int row0, int b,
                                            int h, int grp, int wq, int lane, float sl2) {
  using tc::bf16;
  const int T = a.kv_tiles, L = a.L, g = lane >> 2, t4 = lane & 3;
  wg::mbar_wait(qbar, 0);
  if constexpr (ROPE) {
    // q rotated in place, as K was: the warpgroup's 128 threads take 8
    // pairs of a row each, twice; then wgmma reads it
    const int gt = threadIdx.x % 128;
#pragma unroll
    for (int idx = gt; idx < BKV * 4; idx += 128) {
      const int r = idx >> 2, c0 = (idx & 3) * 8, l = row0 + r;
      if (l >= L) continue;
      tc::rotate8(reinterpret_cast<bf16*>(tq + wg::swizzle128(r, c0)),
                  reinterpret_cast<bf16*>(tq + wg::swizzle128(r, c0 + D2)), a.cos_t + l * D2 + c0,
                  a.sin_t + l * D2 + c0);
    }
    wg::fence_proxy();
    wg::bar_sync(2 + grp, 128);
  }

  // K1's online softmax over the held K and V, on wgmma: S = q k^T from
  // shared memory (q and K both K-major), O += P V with P from registers (V
  // the N-major operand); with RES also O_lo += (P - bf16(P)) V
  float o[8][4], o_lo[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  tc::zero(o);
  if (RES) tc::zero(o_lo);
  for (int j = 0; j < T; ++j) {
    float s[8][4];
    const uint64_t dq = wg::desc(tq, 0, 1024), dk = wg::desc(sK + j * TMA_TILE, 0, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64<0>(s, wg::desc_add(dq, 32 * kk), wg::desc_add(dk, 32 * kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(s);
    float alpha[2];
    tc::online_softmax(s, m, l, alpha, BKV * j, L, sl2, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[n][e] *= alpha[e >> 1];
        if (RES) o_lo[n][e] *= alpha[e >> 1];
      }
    uint32_t pf[4][4], pf_lo[4][4];
    tc::to_a(pf, s);  // P rounded to bf16
    if (RES) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] -= __bfloat162float(__float2bfloat16(s[n][e]));
      tc::to_a(pf_lo, s);
    }
    wg::mbar_wait(&vbar[j], 0);
    const uint64_t dv = wg::desc(sV + j * TMA_TILE, TMA_TILE, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_m64n64_rs<1>(o, pf[kk], wg::desc_add(dv, 2048 * kk), 1);
    if (RES)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64_rs<1>(o_lo, pf_lo[kk], wg::desc_add(dv, 2048 * kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(o);
    if (RES) wg::fence_acc(o_lo);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  // out = bf16(O / l), staged in the warp's own 16 rows of the q tile (the
  // warpgroup's products that read it are done), then 16 bytes a lane
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(tq + wg::swizzle128(16 * wq + g + 8 * hh, 8 * j + 2 * t4)) =
          tc::pack(o[j][2 * hh] * inv[hh], o[j][2 * hh + 1] * inv[hh]);
  __syncwarp();
  const size_t at = a.o.at(b, h);
  bf16* out = a.out + at;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, r = idx >> 3, ch = idx & 7, row = row0 + 16 * wq + r;
    if (row < L)
      *reinterpret_cast<uint4*>(out + (size_t)row * a.o.row + ch * 8) =
          *reinterpret_cast<const uint4*>(tq + wg::swizzle128(16 * wq + r, ch * 8));
  }
  if (!RES) return;
  float* lse = a.lse + ((size_t)b * a.H + h) * L;
  float* of = a.out_f32 + at;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wq + g + 8 * r;
    if (row >= L) continue;
    if (t4 == 0) lse[row] = (m[r] + log2f(l[r])) * tc::LN2;
    float* dst = of + (size_t)row * a.o.row + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2((o[n][2 * r] + o_lo[n][2 * r]) * inv[r],
                      (o[n][2 * r + 1] + o_lo[n][2 * r + 1]) * inv[r]);
  }
}

// Block x of a head's `split` blocks takes (head h, row b) and the query
// tiles x, x + split, ...: thread 0 TMA-loads those q tiles and every K and
// V tile of the head at once, each landing on its own mbarrier (K on one);
// with ROPE the two warpgroups rotate K in shared memory together (once for
// the block). They then take the q tiles
// in turn and run the online softmax of each tile's 64 queries over the
// held K and V on wgmma, S and P in registers. Without ROPE (K7) the
// landed tiles go to wgmma as TMA wrote them.
template <bool ROPE, bool RES>
__device__ __forceinline__ void wgmma_attention_fwd(const CUtensorMap* qmap,
                                                    const CUtensorMap* kmap,
                                                    const CUtensorMap* vmap, const TmaArgs& a) {
  using tc::bf16;
  unsigned char* smem = wg::aligned_smem();
  const int T = a.kv_tiles, L = a.L, h = blockIdx.y, b = blockIdx.z;
  const int split = gridDim.x, x = blockIdx.x, nq = (T - x + split - 1) / split;
  unsigned char* sK = smem;
  unsigned char* sV = smem + T * TMA_TILE;
  unsigned char* sQ = smem + 2 * T * TMA_TILE;  // slot i: query tile x + split * i
  uint64_t* kbar =
      reinterpret_cast<uint64_t*>(smem + (2 * T + tma_q_tiles(T, split)) * TMA_TILE);
  uint64_t* qbar = kbar + 1;
  uint64_t* vbar = qbar + nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {  // the barriers, then every copy at once
    wg::mbar_init(kbar, 1);
    for (int i = 0; i < nq; ++i) wg::mbar_init(&qbar[i], 1);
    for (int j = 0; j < T; ++j) wg::mbar_init(&vbar[j], 1);
    wg::mbar_fence_init();
    wg::tma_prefetch(qmap);
    wg::tma_prefetch(kmap);
    wg::tma_prefetch(vmap);
    const int qc = a.col[0] + a.head * h, kc = a.col[1] + a.head * h;
    const int vc = a.col[2] + a.head * h, z = a.zh ? b * a.H + h : b;
    for (int i = 0; i < nq; ++i) {
      wg::mbar_arrive_expect(&qbar[i], TMA_TILE);
      wg::tma_load_3d(sQ + i * TMA_TILE, qmap, &qbar[i], qc, BKV * (x + split * i), z);
    }
    wg::mbar_arrive_expect(kbar, T * TMA_TILE);
    for (int j = 0; j < T; ++j) wg::tma_load_3d(sK + j * TMA_TILE, kmap, kbar, kc, BKV * j, z);
    for (int j = 0; j < T; ++j) {
      wg::mbar_arrive_expect(&vbar[j], TMA_TILE);
      wg::tma_load_3d(sV + j * TMA_TILE, vmap, &vbar[j], vc, BKV * j, z);
    }
  }
  __syncthreads();

  wg::mbar_wait(kbar, 0);
  if constexpr (ROPE) {
    // K rotated in place once, rows [0, L): a thread takes 8 pairs of a
    // row; rows >= L stay TMA's zeros (their keys get P = 0)
    for (int idx = threadIdx.x; idx < T * BKV * 4; idx += 128 * TMA_GROUPS) {
      const int r = idx >> 2, c0 = (idx & 3) * 8;
      if (r >= L) continue;
      unsigned char* tile = sK + (r / BKV) * TMA_TILE;
      tc::rotate8(reinterpret_cast<bf16*>(tile + wg::swizzle128(r % BKV, c0)),
                  reinterpret_cast<bf16*>(tile + wg::swizzle128(r % BKV, c0 + D2)),
                  a.cos_t + r * D2 + c0, a.sin_t + r * D2 + c0);
    }
    wg::fence_proxy();                  // K, rewritten by threads, is read by wgmma
    wg::bar_sync(1, 128 * TMA_GROUPS);
  }

  const int grp = warp / 4, wq = warp % 4;
  const float sl2 = a.scale * tc::LOG2E;
  for (int i = grp; i < nq; i += TMA_GROUPS)
    attend_tile<ROPE, RES>(a, sK, sV, sQ + i * TMA_TILE, &qbar[i], vbar, BKV * (x + split * i),
                           b, h, grp, wq, lane, sl2);
}

// The Hopper forward's three kernels: K1 (qkv) and K5 (separate q, k, v)
// with the rotation, each with and without the residuals; K7 without
#define HD_TMA_MAPS                                                               \
  const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap, \
      const __grid_constant__ CUtensorMap vmap, TmaArgs a
template <bool RES>
__global__ void __launch_bounds__(TMA_THREADS, RES ? 1 : 2)
    wgmma_rope_attention_qkv_kernel(HD_TMA_MAPS) {
  wgmma_attention_fwd<true, RES>(&qmap, &kmap, &vmap, a);
}
template <bool RES>
__global__ void __launch_bounds__(TMA_THREADS, RES ? 1 : 2)
    wgmma_rope_attention_sep_fwd_kernel(HD_TMA_MAPS) {
  wgmma_attention_fwd<true, RES>(&qmap, &kmap, &vmap, a);
}
__global__ void __launch_bounds__(TMA_THREADS, 2) wgmma_plain_attention_kernel(HD_TMA_MAPS) {
  wgmma_attention_fwd<false, false>(&qmap, &kmap, &vmap, a);
}
#undef HD_TMA_MAPS

enum TmaKind { K1_QKV, K5_SEP, K7_PLAIN };

// The Hopper forward's launch, for `a` over maps of dims (d0, L, d2) whose
// bases are q, k, v (K1: qkv three times). The plan must be this one's own
// for the shape (the caller's ops/fused_attention.py::rope_attention_qkv_plan,
// TMA_PLAN_LEN values): grid (split, H, B), threads, shared-memory bytes,
// K/V tiles, then the maps' dims (3, innermost first), byte strides (2) and
// box (3), one description for the three maps. Returns a cudaError_t code.
template <int KIND, bool RES>
int launch_tma(const void* const (&qkv)[3], const TmaArgs& a, long long d0, long long d2, int B,
               const long long* plan, cudaStream_t stream) {
  const int L = a.L, tiles = a.kv_tiles;
  const long long split = plan[0];
  if (split < 1 || split > tiles || tiles > TMA_MAX_TILES) return (int)cudaErrorInvalidValue;
  const long long want[TMA_PLAN_LEN] = {split, a.H, B, TMA_THREADS,
                                        tma_smem_bytes(tiles, (int)split), tiles, d0, L, d2,
                                        d0 * 2, L * d0 * 2, HD, BKV, 1};
  for (int i = 0; i < TMA_PLAN_LEN; ++i)
    if (plan[i] != want[i]) return (int)cudaErrorInvalidValue;
  if (want[4] > MAX_SMEM) return (int)cudaErrorInvalidValue;
  for (int m = 0; m < 3; ++m)
    if (reinterpret_cast<uintptr_t>(qkv[m]) % 16) return (int)cudaErrorInvalidValue;
  // the limit, set once for the instantiation: the port drives one card per process
  static const cudaError_t attr = [] {
    const void* kernel = KIND == K1_QKV   ? (const void*)wgmma_rope_attention_qkv_kernel<RES>
                         : KIND == K5_SEP ? (const void*)wgmma_rope_attention_sep_fwd_kernel<RES>
                                          : (const void*)wgmma_plain_attention_kernel;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  const cuuint64_t dims[3] = {(cuuint64_t)plan[6], (cuuint64_t)plan[7], (cuuint64_t)plan[8]};
  const cuuint64_t strides[2] = {(cuuint64_t)plan[9], (cuuint64_t)plan[10]};
  const cuuint32_t box[3] = {(cuuint32_t)plan[11], (cuuint32_t)plan[12], (cuuint32_t)plan[13]};
  for (int m = 0; m < 3; ++m)
    if (!wg::encode(&maps[m], qkv[m], 3, dims, strides, box)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)plan[0], (unsigned)plan[1], (unsigned)plan[2]);
  const int bytes = (int)plan[4];
  if (KIND == K1_QKV)
    wgmma_rope_attention_qkv_kernel<RES><<<grid, TMA_THREADS, bytes, stream>>>(maps[0], maps[1],
                                                                            maps[2], a);
  else if (KIND == K5_SEP)
    wgmma_rope_attention_sep_fwd_kernel<RES><<<grid, TMA_THREADS, bytes, stream>>>(
        maps[0], maps[1], maps[2], a);
  else
    wgmma_plain_attention_kernel<<<grid, TMA_THREADS, bytes, stream>>>(maps[0], maps[1], maps[2],
                                                                      a);
  return (int)cudaGetLastError();
}

// launch_tma with the residuals (lse and out_f32 both given) or without
template <int KIND>
int launch_tma_res(const void* const (&qkv)[3], const TmaArgs& a, long long d0, long long d2,
                   int B, const long long* plan, cudaStream_t stream) {
  if ((a.lse == nullptr) != (a.out_f32 == nullptr)) return (int)cudaErrorInvalidValue;
  return a.lse != nullptr ? launch_tma<KIND, true>(qkv, a, d0, d2, B, plan, stream)
                          : launch_tma<KIND, false>(qkv, a, d0, d2, B, plan, stream);
}

bool bad_tma_shape(int B, int L, int H) {
  return B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535;
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

// The Hopper forward (bf16, L <= 384) of K1, K5 and K7. `plan` is the
// launch the caller computed (ops/fused_attention.py::rope_attention_qkv_plan
// with the entry's layout), TMA_PLAN_LEN values: grid x (the blocks a head's
// query tiles are split over), y, z, threads, shared-memory bytes, K/V
// tiles, then the q, k and v maps' dims (3, innermost first), byte strides
// (2) and box (3); a plan other than the entry's own for the shape is
// refused. Every tensor TMA reads lies at a 16-byte aligned address. Each
// returns a cudaError_t code (0 = launched).
//
// K1: qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, out [B, L, H*64];
// the residuals lse [B, H, L] f32 and out_f32 [B, L, H*64] f32, both or
// neither (null: not written).
extern "C" int hd_rope_attention_qkv_tma(const void* qkv, const void* cos_t, const void* sin_t,
                                         void* out, void* lse, void* out_f32, int B, int L,
                                         int H, float scale, const long long* plan,
                                         void* stream) {
  if (bad_tma_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const int A = H * HD;
  const TmaArgs a{static_cast<tc::bf16*>(out), static_cast<float*>(lse),
                  static_cast<float*>(out_f32), Layout{L * A, A, HD},
                  static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, H,
                  (L + BKV - 1) / BKV, {0, HD, 2 * HD}, 3 * HD, 0, scale};
  const void* const bases[3] = {qkv, qkv, qkv};
  return launch_tma_res<K1_QKV>(bases, a, 3LL * A, B, B, plan, static_cast<cudaStream_t>(stream));
}

// K5: q, k, v, out [B, L, H*64], the tables and residuals as K1's.
extern "C" int hd_rope_attention_tma(const void* q, const void* k, const void* v,
                                     const void* cos_t, const void* sin_t, void* out, void* lse,
                                     void* out_f32, int B, int L, int H, float scale,
                                     const long long* plan, void* stream) {
  if (bad_tma_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const int A = H * HD;
  const TmaArgs a{static_cast<tc::bf16*>(out), static_cast<float*>(lse),
                  static_cast<float*>(out_f32), Layout{L * A, A, HD},
                  static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, H,
                  (L + BKV - 1) / BKV, {0, 0, 0}, HD, 0, scale};
  const void* const bases[3] = {q, k, v};
  return launch_tma_res<K5_SEP>(bases, a, A, B, B, plan, static_cast<cudaStream_t>(stream));
}

// K7: q, k, v and out [B, L, H, 64] (layout 0) or [B, H, L, 64] (layout 1,
// read through maps over [B H][L][64]); no RoPE, no residuals.
extern "C" int hd_attention_tma(const void* q, const void* k, const void* v, void* out, int B,
                                int L, int H, int layout, float scale, const long long* plan,
                                void* stream) {
  if (bad_tma_shape(B, L, H) || (layout != 0 && layout != 1)) return (int)cudaErrorInvalidValue;
  const int A = H * HD;
  TmaArgs a{static_cast<tc::bf16*>(out), nullptr, nullptr, Layout{L * A, A, HD}, nullptr,
            nullptr, L, H, (L + BKV - 1) / BKV, {0, 0, 0}, HD, 0, scale};
  long long d0 = A, d2 = B;
  if (layout == 1) {  // maps over [B H][L][64]: no column per head, a row of them per head
    a.o = Layout{A * L, HD, L * HD};
    a.head = 0;
    a.zh = 1;
    d0 = HD;
    d2 = (long long)B * H;
  }
  const void* const bases[3] = {q, k, v};
  return launch_tma<K7_PLAIN, false>(bases, a, d0, d2, B, plan,
                                     static_cast<cudaStream_t>(stream));
}
