// K4: backward of the ByteNet residual block (K2), as five launches, in two
// designs.
//
// Replaces hudiff_tpu/ops/pallas_bytenet.py::_bwd_kernel (called through
// _pallas_bwd, the backward of the custom VJP around K2).
//
// What it computes, from the block input x, the saved pre-LayerNorm outputs
// p (Dense) and q (conv), the weights in the activation type cd, the f32
// LayerNorm parameters and dy, with LN = f32 LayerNorm (eps 1e-6, var =
// E[z^2] - E[z]^2), act' the activation's derivative (ReLU: u > 0; GELU:
// exact erf, cdf + u pdf) and every product of cd values accumulated in f32:
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
// all B*L rows. The gradients are f32.
//
// What bounds it on an H100: operations. The backward executes twice the
// forward's products (data and weight gradients): for the 768/384 block at
// B=128, L=152, about 126 GFLOP, 0.128 ms at 989 TFLOP/s bf16, against
// about 100 MB of inputs and outputs (0.03 ms at 3.35 TB/s).
//
// The TPU kernel accumulated the 12 parameter gradients across its
// sequential batch-tile grid; on the card they are reductions over the B*L
// rows (19,456 at B=128) across blocks that run in no order, done as
// fixed-order two-step sums with no atomics, so a call repeats to the same
// bits. Both designs launch:
//   1-3. the data GEMMs de = dy W2, dbb = conv^T(dq) Wc, da = dp W1, each
//        with the LayerNorm backward in its epilogue: act(LN z) (e, bb or a,
//        the other operand of step 4) and dq, dp or dx written, the tile's
//        column partials of the LN parameter and bias gradients kept; de,
//        dbb and da never reach device memory. The row statistics of z that
//        K2 writes are read when given (so that both passes make the same
//        ReLU decisions), else taken here;
//   4.   the three weight gradients in one grouped launch, the rows split
//        into chunks with an f32 partial each;
//   5.   bytenet_bwd_sum_kernel: every partial summed in a fixed order.
//
// Hopper design (bf16, D and H multiples of 128 up to 1024; TMA +
// mbarriers + wgmma on wgmma_tiles.cuh). The data GEMMs
// (wgmma_bytenet_bwd_data_kernel) take 128 x 128 tiles of the B*L rows and
// N columns: a producer warp keeps a ring of four 32 KB stages full (the A
// rows, with the transposed conv's tap box started -(t - (K - 1) / 2) dil
// rows on; the weights' 64 rows as they lie, [C, taps N], the N-major B
// operand); each of two consumer warpgroups takes 64 rows over every chunk
// in a chain of wgmma m64n128k16 and zeroes its A rows whose tap row lies in
// another chain (the conv's padding). A block does not own whole rows: the
// launch is a cluster over the row tile's N / 128 column tiles, which
// exchange the rows' sums (of z where the statistics are not given, of dn
// and dn n) through distributed shared memory in rank order, so every block
// holds the same means. The epilogue runs over the products put in shared
// memory in small loops, a warp a row (an unrolled epilogue, per
// accumulator register, ran several times the products' time from
// instruction-cache misses); z and the residual arrive by TMA with the first
// chunks. The weight gradients (wgmma_bytenet_bwd_wgrad_kernel) take 128 x
// 128 tiles of dW2, dWc, dW1 over one split of the rows: X^T (dy, cd(dq),
// cd(dp)) is read from [rows, P] boxes as an M-major A operand (wgmma's
// transpose-A bit), Y (e, bb at tap t's shift, a) as the N-major B; for dWc
// a group zeroes its X rows whose tap row lies in another chain. Two
// blocks share an SM. ops/fused_bytenet.py::bytenet_block_backward_plan
// computes every launch (grids, clusters, stages, splits, the workspace and
// twelve tensor maps) and hd_bytenet_block_bwd_tma refuses any other.
//
// The cp.async + mma.sync design (the demos' widths, and on request;
// gemm_tiles.cuh's pipelined core), f32 on its FMA path:
//   1-3. bytenet_bwd_data_kernel: a block owns whole rows (up to 1024
//        columns: 8 warps side by side, BM = 64, 32 or 16 rows by width);
//        once the ring is drained, the block puts its rows of z (one
//        cp.async batch) and its accumulator in shared memory and loops
//        over them: a warp a row for the statistics, act(LN z) and the
//        output, a thread a column for the partials. The conv-transposed
//        operand gathers row m - shift_t of the chain.
//   4.   bytenet_bwd_wgrad_kernel: 128 x 128 tiles; bb gathered per tap,
//        zero outside the chain.
// The weights arrive in cd (the forward's copies), so no block rounds a
// weight. Wide rows (more than 384 columns) stage 64-byte chunks so that
// three slots fit in shared memory. The port has no length padding: rows
// outside a chain read as zeros, which is what the TPU kernel's row masks
// (_row_mask) achieve on its padded rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bytenet_tiles.cuh"
#include "gemm_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace hd::gemm;
namespace tc = hd::tc;

constexpr int WGRAD_TARGET = 4 * 132;  // blocks a weight-gradient launch aims at
constexpr int WGRAD_MIN_ROWS = 512;    // rows of a split, at least

__host__ __device__ constexpr size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// ---------------------------------------------------------------------------
// 1-3. data-gradient GEMMs with the LayerNorm backward in the epilogue
// ---------------------------------------------------------------------------

template <typename T> struct DataArgs {
  const T* a;      // A rows [M, C]: dy, dq (gathered per tap) or dp
  const T* w;      // weights: element (k = (tap t, channel ch), n) at w[ch ld_c + t ld_t + n]
  const T* z;      // the LayerNorm's input [M, N]: q, p or x
  const float2* stats;  // its rows' (mean, 1/sigma) [M] from the forward, or nullptr: taken here
  const float* g;  // its scale and bias [N]
  const float* b;
  const T* res;    // [M, N] added to the result, or nullptr
  T* out;          // [M, N] = cd([res +] LN^T(acc act'(h) g))
  T* act;          // [M, N] out: cd(act(LN z)), e, bb or a
  float* part;     // [3][gridDim.x][N]: sum dh n, sum dh, sum (res ? res : result)
  int M, C, N, L, taps, dil, ld_c, ld_t, gelu;
};

// n-tiles of 8 columns a warp holds for a row of n columns (8 warps side by side)
int data_ntw(int n) {
  const int need = (n + 63) / 64;
  return need <= 2 ? 2 : need <= 4 ? 4 : need <= 6 ? 6 : need <= 8 ? 8 : need <= 12 ? 12 : 16;
}
// rows of a block: 96 or fewer accumulators a thread
__host__ __device__ constexpr int data_bm(int ntw) { return ntw <= 6 ? 64 : ntw <= 12 ? 32 : 16; }

template <typename T, int NTW> struct DataTile {
  static constexpr int BM = data_bm(NTW), MT = BM / 16, NB = 64 * NTW;
  static constexpr int V = VEC<T>, BK = (NTW <= 6 ? 128 : 64) / (int)sizeof(T);
  static constexpr int LDA = BK + V, LDB = NB + V;  // A [BM][LDA], B [BK][LDB]
  static constexpr int A_SLOT = BM * LDA, B_SLOT = BK * LDB;
  static constexpr int LDZ = NB + V;  // the epilogue's z rows [BM][LDZ]
  static constexpr int LDD = NB + 8;  // ... and accumulator rows [BM][LDD], f32
  static constexpr size_t RING = (size_t)STAGES * (A_SLOT + B_SLOT) * sizeof(T);
  static constexpr size_t ROWS = (size_t)BM * LDZ * sizeof(T) + (size_t)BM * LDD * sizeof(float);
  static constexpr size_t ROW_INFO = RING > ROWS ? RING : ROWS;
  // the ring (z and the accumulator once it is drained) and each row's
  // (mean, 1/sigma, mean(dn), mean(dn n)) [BM]
  static constexpr size_t SMEM = ROW_INFO + (size_t)BM * sizeof(float4);
};

// LN^T of one element: (dn - mean(dn) - n mean(dn n)) / sigma
__device__ __forceinline__ float ln_bwd(float dn, float n, float m1, float m2, float inv) {
  return (dn - m1 - n * m2) * inv;
}

// Chunks are issued in order, so the next chunk's tap and depth are
// counters, and a thread's A rows (the same every chunk) keep their position
// in the chain: no division in the loop.
template <typename T, int NTW> struct DataOp {
  using Tl = DataTile<T, NTW>;
  static constexpr bool TRANSFORM = false;
  static constexpr int W = Tl::BK / Tl::V;  // vectors of a chunk row
  static constexpr int NA = Tl::BM * W, RA = (NA + THREADS - 1) / THREADS;  // a thread's rows
  static_assert(THREADS % W == 0, "a thread keeps its column");
  const DataArgs<T>& p;
  T* sA;
  T* sB;
  int m0, cpt;  // chunks per tap
  int t, kc;    // the next chunk's tap and chunk within the tap
  int la[RA];   // a thread's A rows: position in the chain, -1 past M or past the tile

  static __device__ __forceinline__ int row(int i) {
    return ((int)threadIdx.x + i * THREADS) / W;
  }
  __device__ __forceinline__ void init() {
    t = kc = 0;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int m = m0 + row(i);
      la[i] = (int)threadIdx.x + i * THREADS < NA && m < p.M ? m % p.L : -1;
    }
  }
  __device__ __forceinline__ void issue(int, int slot) {
    const int k0 = kc * Tl::BK, v = threadIdx.x % W, ch = k0 + v * Tl::V;
    const int s = -(t - (p.taps - 1) / 2) * p.dil;  // the transposed conv: row m reads m + s
    T* a_dst = sA + slot * Tl::A_SLOT;
    T* b_dst = sB + slot * Tl::B_SLOT;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      if (NA % THREADS && (int)threadIdx.x + i * THREADS >= NA) break;
      const int r = row(i), l = la[i] + s;
      const bool ok = la[i] >= 0 && l >= 0 && l < p.L && ch < p.C;
      tc::cp_async16(a_dst + r * Tl::LDA + v * Tl::V,
                     ok ? p.a + (size_t)(m0 + r + s) * p.C + ch : p.a, ok);
    }
    const int tap = t;
    for_vectors<Tl::BK, Tl::NB / Tl::V>([&](int r, int v) {
      const int ch = k0 + r, n = v * Tl::V;
      const bool ok = ch < p.C && n < p.N;
      tc::cp_async16(b_dst + r * Tl::LDB + n,
                     ok ? p.w + (size_t)ch * p.ld_c + (size_t)tap * p.ld_t + n : p.w, ok);
    });
    if (++kc == cpt) {
      kc = 0;
      ++t;
    }
  }
  __device__ __forceinline__ void transform(int, int) {}
};

template <typename T, int NTW>
__global__ void __launch_bounds__(THREADS) bytenet_bwd_data_kernel(DataArgs<T> p) {
  using Tl = DataTile<T, NTW>;
  constexpr int BM = Tl::BM, MT = Tl::MT, V = Tl::V, LDZ = Tl::LDZ, LDD = Tl::LDD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * Tl::A_SLOT;
  T* sZ = sA;  // [BM][LDZ], over the drained ring
  float* sD = reinterpret_cast<float*>(smem + (size_t)BM * LDZ * sizeof(T));  // [BM][LDD]
  float4* sRow = reinterpret_cast<float4*>(smem + Tl::ROW_INFO);              // [BM]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;

  DataOp<T, NTW> op{p, sA, sB, m0, (p.C + Tl::BK - 1) / Tl::BK};
  op.init();
  float acc[MT][NTW][4];
  zero(acc);
  const int wn = warp * 8 * NTW;
  mainloop<T, MT, NTW, Tl::BK, false, true>(acc, op, p.taps * op.cpt, sA, Tl::A_SLOT,
                                            Pad{Tl::LDA}, sB, Tl::B_SLOT, Pad{Tl::LDB}, 0, wn,
                                            lane);

  // the block's rows of z and the accumulator, over the drained ring; the
  // epilogue below runs loops over them rather than unrolled code per
  // accumulator register, which ran from the instruction cache's misses
  for_vectors<BM, Tl::NB / V>([&](int r, int v) {
    const int m = m0 + r, c = v * V;
    const bool ok = m < p.M && c < p.N;
    tc::cp_async16(sZ + r * LDZ + c, ok ? p.z + (size_t)m * p.N + c : p.z, ok);
  });
  tc::cp_async_commit();
  {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(sD + (16 * i + g + 8 * h) * LDD + wn + 8 * j + 2 * tq) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // rows, a warp each: the LayerNorm statistics; act(LN z) for the weight
  // gradients; dh = d act'(h), kept in sD; the means of dn = dh g and of
  // dn n; out = cd([res +] LN^T(dn))
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= p.M) break;
    const T* zr = sZ + r * LDZ;
    float* dr = sD + r * LDD;
    const float2 st = p.stats ? p.stats[m] : row_stats(zr, p.N, lane);
    for (int c = lane * V; c < p.N; c += 32 * V) {
      Pack<T> q;
      q.u = *reinterpret_cast<const uint4*>(zr + c);
      ln_act_pack(q, st, p.g + c, p.b + c, p.gelu);
      *reinterpret_cast<uint4*>(p.act + (size_t)m * p.N + c) = q.u;
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = 2 * lane; c < p.N; c += 64) {
      const float2 zz = load2(zr + c), gc = load2(p.g + c), bc = load2(p.b + c);
      float2 d = *reinterpret_cast<const float2*>(dr + c);
      d.x *= dact_fn(ln_affine(zz.x, st, gc.x, bc.x), p.gelu);
      d.y *= dact_fn(ln_affine(zz.y, st, gc.y, bc.y), p.gelu);
      *reinterpret_cast<float2*>(dr + c) = d;
      const float dn0 = d.x * gc.x, dn1 = d.y * gc.y;
      s1 += dn0 + dn1;
      s2 += dn0 * ln_norm(zz.x, st) + dn1 * ln_norm(zz.y, st);
    }
    const float m1 = warp_sum(s1) / p.N, m2 = warp_sum(s2) / p.N;
    if (lane == 0) sRow[r] = make_float4(st.x, st.y, m1, m2);
#pragma unroll 4
    for (int c = 2 * lane; c < p.N; c += 64) {
      const float2 zz = load2(zr + c), gc = load2(p.g + c);
      const float2 d = *reinterpret_cast<const float2*>(dr + c);
      float v0 = ln_bwd(d.x * gc.x, ln_norm(zz.x, st), m1, m2, st.y);
      float v1 = ln_bwd(d.y * gc.y, ln_norm(zz.y, st), m1, m2, st.y);
      if (p.res) {
        const float2 rr = load2(p.res + (size_t)m * p.N + c);
        v0 = rr.x + v0;
        v1 = rr.y + v1;
      }
      store2(p.out + (size_t)m * p.N + c, v0, v1);
    }
  }
  __syncthreads();

  // columns, a thread each, over the block's rows in order: the partial sums
  // of dh n, dh and (res ? res : the result before rounding)
  const int rows = min(BM, p.M - m0);
  const size_t pstride = (size_t)gridDim.x * p.N;
  float* part = p.part + (size_t)blockIdx.x * p.N;
  for (int c = threadIdx.x; c < p.N; c += THREADS) {
    const float gc = p.g[c];
    float pg = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float4 ri = sRow[r];
      const float dh = sD[r * LDD + c], n = ln_norm(to_f(sZ[r * LDZ + c]), make_float2(ri.x, ri.y));
      pg += dh * n;
      pb += dh;
      pc += p.res ? to_f(p.res[(size_t)(m0 + r) * p.N + c]) : ln_bwd(dh * gc, n, ri.z, ri.w, ri.y);
    }
    part[c] = pg;
    part[pstride + c] = pb;
    part[2 * pstride + c] = pc;
  }
}

// ---------------------------------------------------------------------------
// 4. weight gradients: part[s][P, Q] = sum over the rows m of split s of
// X[m, P] x Y[m, Q] (both cd), three jobs in one launch
// ---------------------------------------------------------------------------

template <typename T> struct WJob {
  const T* x;     // [M, P]: dy, dq or dp, read transposed
  const T* y;     // [M, C]: e, bb or a (steps 1-3 wrote them)
  float* part;    // [splits][P][Q], Q = taps C: column (t, i) is row m + shift_t, channel i
  int P, C, taps, first;  // first: the job's first block
};
template <typename T> struct WArgs {
  WJob<T> job[3];
  int M, L, dil, chunk;  // chunk: rows of a split
};

template <typename T> struct WTile {
  static constexpr int BM = 128, BN = 128, WM = 64, WN = 32, MT = 4, NT = 4;  // 2 x 4 warps
  static constexpr int V = VEC<T>, BK = 128 / (int)sizeof(T);
  static constexpr int LDA = BM + V, LDB = BN + V;  // both [BK][.]: rows of the depth
  static constexpr int A_SLOT = BK * LDA, B_SLOT = BK * LDB;
  static constexpr size_t SMEM = (size_t)STAGES * (A_SLOT + B_SLOT) * sizeof(T);
};

// Chunks are issued in order: a thread's B column (and so its tap and
// channel) is fixed, and its rows' positions in the chain advance by BK a
// chunk: no division in the loop.
template <typename T> struct WOp {
  using Tl = WTile<T>;
  static constexpr bool TRANSFORM = false;
  static constexpr int WA = Tl::BM / Tl::V, WB = Tl::BN / Tl::V;  // vectors of a chunk row
  static constexpr int RB = Tl::BK * WB / THREADS;                 // a thread's B rows
  static_assert(THREADS % WB == 0 && Tl::BK * WB % THREADS == 0, "a thread keeps its column");
  const WJob<T>& jb;
  T* sA;
  T* sB;
  int L, dil, mb, me, p0, q0, Q;
  int k0;                 // the next chunk's first row
  int qi, s;              // this thread's B column: channel, and its tap's shift
  bool qok;
  int lb[RB];             // its B rows' positions in their chains

  static __device__ __forceinline__ int brow(int i) {
    return (int)threadIdx.x / WB + i * (THREADS / WB);
  }
  __device__ __forceinline__ void init() {
    k0 = mb;
    const int q = q0 + (int)(threadIdx.x % WB) * Tl::V, t = q / jb.C;
    qi = q - t * jb.C;
    s = (t - (jb.taps - 1) / 2) * dil;
    qok = q < Q;
#pragma unroll
    for (int i = 0; i < RB; ++i) lb[i] = (mb + brow(i)) % L;
  }
  __device__ __forceinline__ void issue(int, int slot) {
    T* a_dst = sA + slot * Tl::A_SLOT;
    T* b_dst = sB + slot * Tl::B_SLOT;
    for_vectors<Tl::BK, WA>([&](int r, int v) {
      const int m = k0 + r, pp = p0 + v * Tl::V;
      const bool ok = m < me && pp < jb.P;
      tc::cp_async16(a_dst + r * Tl::LDA + v * Tl::V, ok ? jb.x + (size_t)m * jb.P + pp : jb.x, ok);
    });
    const int v = threadIdx.x % WB;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = brow(i), m = k0 + r, l = lb[i] + s;
      const bool ok = qok && m < me && l >= 0 && l < L;
      tc::cp_async16(b_dst + r * Tl::LDB + v * Tl::V,
                     ok ? jb.y + (size_t)(m + s) * jb.C + qi : jb.y, ok);
      lb[i] += Tl::BK;
      while (lb[i] >= L) lb[i] -= L;
    }
    k0 += Tl::BK;
  }
  __device__ __forceinline__ void transform(int, int) {}
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) bytenet_bwd_wgrad_kernel(WArgs<T> a) {
  using Tl = WTile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * Tl::A_SLOT;
  const int bx = blockIdx.x;  // the job by selects, not an index into the parameters
  const WJob<T> jb = bx >= a.job[2].first ? a.job[2] : bx >= a.job[1].first ? a.job[1] : a.job[0];
  const int Q = jb.taps * jb.C;
  const int tiles_q = (Q + Tl::BN - 1) / Tl::BN;
  const int tiles = ((jb.P + Tl::BM - 1) / Tl::BM) * tiles_q;
  const int local = bx - jb.first, s = local / tiles, tile = local % tiles;
  const int p0 = (tile / tiles_q) * Tl::BM, q0 = (tile % tiles_q) * Tl::BN;
  const int mb = s * a.chunk, me = min(a.M, mb + a.chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  WOp<T> op{jb, sA, sB, a.L, a.dil, mb, me, p0, q0, Q};
  op.init();
  float acc[Tl::MT][Tl::NT][4];
  zero(acc);
  const int wm = (warp / 4) * Tl::WM, wn = (warp % 4) * Tl::WN;
  const int nchunks = me > mb ? (me - mb + Tl::BK - 1) / Tl::BK : 0;
  mainloop<T, Tl::MT, Tl::NT, Tl::BK, true, true>(acc, op, nchunks, sA, Tl::A_SLOT,
                                                  Pad{Tl::LDA}, sB, Tl::B_SLOT, Pad{Tl::LDB},
                                                  wm, wn, lane);
  float* dst = jb.part + (size_t)s * jb.P * Q;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = p0 + wm + 16 * i + g + 8 * h;
#pragma unroll
      for (int jj = 0; jj < Tl::NT; ++jj) {
        const int q = q0 + wn + 8 * jj + 2 * tq;
        if (pp < jb.P && q < Q)
          store2(dst + (size_t)pp * Q + q, acc[i][jj][2 * h], acc[i][jj][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// 5. out[i] = sum_s part[s][i] in a fixed order, for every partial at once
// ---------------------------------------------------------------------------

constexpr int SUM_JOBS = 12;
constexpr int SUM_WIDE = 8192;     // values of a job from which a thread takes one
constexpr int SUM_BLOCKS = 2 * 132;  // blocks of a job: the grid strides over the rest
struct SumJob {
  const float* part;
  float* out;
  int S, n;
};
struct SumJobs { SumJob job[SUM_JOBS]; };

__global__ void __launch_bounds__(256) bytenet_bwd_sum_kernel(SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.y];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, all = gridDim.x * blockDim.x;
  if (jb.S <= 32 || jb.n >= SUM_WIDE) {  // a thread a value, the partials in order
    for (int i = tid; i < jb.n; i += all) {
      float t = 0.f;
#pragma unroll 4
      for (int s = 0; s < jb.S; ++s) t += jb.part[(size_t)s * jb.n + i];
      jb.out[i] = t;
    }
    return;
  }
  // few values with many partials (the column partials): a warp a value,
  // lane l sums partials l, l + 32, ... in order, then the lanes in a fixed
  // butterfly
  const int lane = threadIdx.x % 32;
  for (int i = tid / 32; i < jb.n; i += all / 32) {
    float t = 0.f;
    for (int s = lane; s < jb.S; s += 32) t += jb.part[(size_t)s * jb.n + i];
    t = warp_sum(t);
    if (lane == 0) jb.out[i] = t;
  }
}

// ---------------------------------------------------------------------------
// host side: workspace layout and launches
// ---------------------------------------------------------------------------

int wgrad_tiles(int P, int Q) { return ((P + 127) / 128) * ((Q + 127) / 128); }

struct Layout {
  size_t dq, dp, e, bb, a, col1, col2, col3, w2p, wcp, w1p, bytes;
  int nb1, nb3;       // data-GEMM row tiles: of H columns (steps 1, 2), of D (step 3)
  int chunk, splits;  // weight gradients: rows of a split, splits
};

// The workspace of either design: the bf16 intermediates, the column
// partials of the data GEMMs' nb1 / nb3 row tiles, the splits' f32 partials
Layout layout_of(size_t M, int D, int H, int K, size_t cd, int nb1, int nb3, int splits,
                 int chunk) {
  Layout t;
  t.nb1 = nb1;
  t.nb3 = nb3;
  t.splits = splits;
  t.chunk = chunk;
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  t.dq = take(M * H * cd);
  t.dp = take(M * H * cd);
  t.e = take(M * H * cd);
  t.bb = take(M * H * cd);
  t.a = take(M * D * cd);
  t.col1 = take((size_t)3 * t.nb1 * H * 4);
  t.col2 = take((size_t)3 * t.nb1 * H * 4);
  t.col3 = take((size_t)3 * t.nb3 * D * 4);
  t.w2p = take((size_t)t.splits * D * H * 4);
  t.wcp = take((size_t)t.splits * H * K * H * 4);
  t.w1p = take((size_t)t.splits * H * D * 4);
  t.bytes = off;
  return t;
}

// rows of a split, a multiple of 64, for `splits` splits of M rows
int split_rows(size_t M, int splits) { return (int)(((M + splits - 1) / splits + 63) / 64 * 64); }

Layout layout(int B, int L, int D, int H, int K, size_t cd) {
  const size_t M = (size_t)B * L;
  const int tiles = wgrad_tiles(D, H) + wgrad_tiles(H, K * H) + wgrad_tiles(H, D);
  int splits = (WGRAD_TARGET + tiles - 1) / tiles;
  const int most = (int)((M + WGRAD_MIN_ROWS - 1) / WGRAD_MIN_ROWS);
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  const int chunk = split_rows(M, splits);
  return layout_of(M, D, H, K, cd, (int)((M + data_bm(data_ntw(H)) - 1) / data_bm(data_ntw(H))),
                   (int)((M + data_bm(data_ntw(D)) - 1) / data_bm(data_ntw(D))),
                   (int)((M + chunk - 1) / chunk), chunk);
}

// blocks of the sum launch: a thread a value of the widest job, at most SUM_BLOCKS
int sum_blocks(int D, int H, int K) {
  const int widest = H * K * H > D * H ? H * K * H : D * H;
  return (widest + 255) / 256 < SUM_BLOCKS ? (widest + 255) / 256 : SUM_BLOCKS;
}

struct Grads { float *g1, *b1, *w1, *c1, *g2, *b2, *wc, *cc, *g3, *b3, *w2, *c2; };

// 5. every partial of the workspace at ws (layout t) summed into the gradients
cudaError_t sum_all(const Grads& gr, const Layout& t, unsigned char* ws, int D, int H, int K,
                    cudaStream_t stream) {
  const float* col1 = reinterpret_cast<const float*>(ws + t.col1);  // [3][nb1][H]: g3, b3, cc
  const float* col2 = reinterpret_cast<const float*>(ws + t.col2);  // [3][nb1][H]: g2, b2, c1
  const float* col3 = reinterpret_cast<const float*>(ws + t.col3);  // [3][nb3][D]: g1, b1, c2
  const size_t nh = (size_t)t.nb1 * H, nd = (size_t)t.nb3 * D;
  SumJobs sj{{{reinterpret_cast<const float*>(ws + t.w2p), gr.w2, t.splits, D * H},
              {reinterpret_cast<const float*>(ws + t.wcp), gr.wc, t.splits, H * K * H},
              {reinterpret_cast<const float*>(ws + t.w1p), gr.w1, t.splits, H * D},
              {col1, gr.g3, t.nb1, H}, {col1 + nh, gr.b3, t.nb1, H},
              {col1 + 2 * nh, gr.cc, t.nb1, H},
              {col2, gr.g2, t.nb1, H}, {col2 + nh, gr.b2, t.nb1, H},
              {col2 + 2 * nh, gr.c1, t.nb1, H},
              {col3, gr.g1, t.nb3, D}, {col3 + nd, gr.b1, t.nb3, D},
              {col3 + 2 * nd, gr.c2, t.nb3, D}}};
  bytenet_bwd_sum_kernel<<<dim3(sum_blocks(D, H, K), SUM_JOBS), 256, 0, stream>>>(sj);
  return cudaGetLastError();
}

template <typename T, int NTW> cudaError_t data_tiled(const DataArgs<T>& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bytenet_bwd_data_kernel<T, NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return attr;
  constexpr int BM = DataTile<T, NTW>::BM;
  bytenet_bwd_data_kernel<T, NTW><<<(a.M + BM - 1) / BM, THREADS, DataTile<T, NTW>::SMEM, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T> cudaError_t data(const DataArgs<T>& a, cudaStream_t stream) {
  switch (data_ntw(a.N)) {
    case 2: return data_tiled<T, 2>(a, stream);
    case 4: return data_tiled<T, 4>(a, stream);
    case 6: return data_tiled<T, 6>(a, stream);
    case 8: return data_tiled<T, 8>(a, stream);
    case 12: return data_tiled<T, 12>(a, stream);
    default: return data_tiled<T, 16>(a, stream);
  }
}

template <typename T> cudaError_t wgrad(const WArgs<T>& a, int blocks, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bytenet_bwd_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return attr;
  bytenet_bwd_wgrad_kernel<T><<<blocks, THREADS, WTile<T>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* p, const T* q, const float2* stats, const float* const* prm,
           const T* w1, const T* wc, const T* w2, const T* dy, T* dx, const Grads& gr,
           unsigned char* ws, int B, int L, int D, int H, int K, int dil, int gelu,
           cudaStream_t stream, int* launched) {
  // prm: g1, b1, c1, g2, b2, cc, g3, b3, c2 (f32; the biases are not read);
  // stats: the forward's [3][M] (x, p, q) or nullptr
  const int M = B * L;
  const float2* sx = stats;
  const float2* sp = stats ? stats + M : nullptr;
  const float2* sq = stats ? stats + 2 * (size_t)M : nullptr;
  const Layout t = layout(B, L, D, H, K, sizeof(T));
  T* dq = reinterpret_cast<T*>(ws + t.dq);
  T* dp = reinterpret_cast<T*>(ws + t.dp);
  T* e = reinterpret_cast<T*>(ws + t.e);    // act(LN3 q)
  T* bb = reinterpret_cast<T*>(ws + t.bb);  // act(LN2 p)
  T* a = reinterpret_cast<T*>(ws + t.a);    // act(LN1 x)
  float* col1 = reinterpret_cast<float*>(ws + t.col1);
  float* col2 = reinterpret_cast<float*>(ws + t.col2);
  float* col3 = reinterpret_cast<float*>(ws + t.col3);
  float* w2p = reinterpret_cast<float*>(ws + t.w2p);
  float* wcp = reinterpret_cast<float*>(ws + t.wcp);
  float* w1p = reinterpret_cast<float*>(ws + t.w1p);
  cudaError_t err;
#define HD_STEP(call)                                   \
  if ((err = (call)) != cudaSuccess) return (int)err; \
  ++*launched;

  HD_STEP(data<T>({dy, w2, q, sq, prm[6], prm[7], nullptr, dq, e, col1, M, D, H, L, 1, 0, H, 0,
                   gelu}, stream));
  HD_STEP(data<T>({dq, wc, p, sp, prm[3], prm[4], nullptr, dp, bb, col2, M, H, H, L, K, dil,
                   K * H, H, gelu}, stream));
  HD_STEP(data<T>({dp, w1, x, sx, prm[0], prm[1], dy, dx, a, col3, M, H, D, L, 1, 0, D, 0,
                   gelu}, stream));
  WArgs<T> wa{{{dy, e, w2p, D, H, 1, 0}, {dq, bb, wcp, H, H, K, 0}, {dp, a, w1p, H, D, 1, 0}},
              M, L, dil, t.chunk};
  wa.job[1].first = wgrad_tiles(D, H) * t.splits;
  wa.job[2].first = wa.job[1].first + wgrad_tiles(H, K * H) * t.splits;
  const int blocks = wa.job[2].first + wgrad_tiles(H, D) * t.splits;
  HD_STEP(wgrad<T>(wa, blocks, stream));

  HD_STEP(sum_all(gr, t, ws, D, H, K, stream));
#undef HD_STEP
  return 0;
}

// ---------------------------------------------------------------------------
// bf16, D and H multiples of 128: TMA + wgmma (Hopper)
// ---------------------------------------------------------------------------

namespace wg = hd::wg;
namespace cg = cooperative_groups;
using hd::bt::crosses;
using hd::bt::release;
using hd::bt::store4;
using hd::bt::unpack4;
using hd::bt::zero_rows;

constexpr int TMA_BM = 128;                 // rows of a data tile: 64 a consumer warpgroup
constexpr int TMA_BN = 128;                 // its columns; a weight-gradient tile is 128 x 128
constexpr int TMA_GROUP_WARPS = 4;          // a consumer warpgroup; two a block
constexpr int TMA_CONSUMERS = 2 * TMA_GROUP_WARPS;
constexpr int TMA_THREADS = (TMA_CONSUMERS + 1) * 32;  // and one producer warp
constexpr int BOX = 64 * 128;               // a 64 x 64 bf16 box of 128-byte rows: 8 KB
constexpr int TMA_MAX_SMEM = 232448;        // dynamic shared memory a block may use
constexpr int MAX_CLUSTER = 8;              // the portable cluster size
constexpr int DATA_STAGES = 3;              // two blocks an SM
constexpr int Z_STAGE = 2;                  // the stage z lands in after the last chunk
constexpr int WGRAD_STAGES[2] = {3, 6};     // two blocks an SM, or one
constexpr int N_MAPS = 12;                  // dy, w2, q, dq, wc, p, dp, w1, x, e, bb, a
constexpr int PLAN_LEN = 28 + 5 * N_MAPS;

// A data GEMM's shared memory from the aligned base: the ring (a stage: the
// A rows as two 64-row boxes, one a warpgroup, and the weights' 64 rows as
// two 64-column boxes), the mbarriers (full and empty a stage, z's), the
// rows' statistics, exchanged sums and means of dn and dn n [128] float2
// each, and the tile's columns of the LayerNorm's g and b. After the
// products the ring holds the tile's dh, f32 [128][128] (DTile, stages 0
// and 1; then the warps' column partials), and z (stage Z_STAGE, its rows
// and columns in four boxes: the 64-column boxes of rows 0-63, then of rows
// 64-127), which the producer asks for once the last chunk has freed it.
struct DataSmem {
  static constexpr int STAGE = 4 * BOX;
  int stages;
  __host__ __device__ constexpr int bars() const { return stages * STAGE; }
  __host__ __device__ constexpr int stat() const { return bars() + 256; }
  __host__ __device__ constexpr int par() const { return stat() + 3 * TMA_BM * 8; }
  __host__ __device__ constexpr int bytes() const {
    return par() + 2 * TMA_BN * 4 + wg::SMEM_SLACK;
  }
};
static_assert(TMA_BM * TMA_BN * 4 <= Z_STAGE * DataSmem::STAGE && Z_STAGE < DATA_STAGES,
              "dh fits the stages before z's");

// Four neighbouring elements (c a multiple of 4) of a bf16 tile of 128 rows
// and 128 columns laid out as four TMA boxes (see DataSmem), as f32
__device__ __forceinline__ float4 tile4(const unsigned char* t, int r, int c) {
  return unpack4(*reinterpret_cast<const uint2*>(t + (2 * (r >> 6) + (c >> 6)) * BOX +
                                                wg::swizzle128(r & 63, c & 63)));
}

// A weight-gradient block's: the ring (a stage: two boxes of X^T's 128
// columns and two of Y's over 64 rows), its mbarriers
struct WgradSmem {
  static constexpr int STAGE = 4 * BOX;
  int stages;
  __host__ __device__ constexpr int bars() const { return stages * STAGE; }
  __host__ __device__ constexpr int bytes() const { return bars() + 256 + wg::SMEM_SLACK; }
};
static_assert(TMA_CONSUMERS * 3 * TMA_BN * 4 <= DATA_STAGES * DataSmem::STAGE,
              "the column partials fit the ring");

// What a data GEMM reads and writes besides its three tensor maps
struct TmaDataArgs {
  const float2* stats;  // the z rows' (mean, 1/sigma) [M] from the forward, or nullptr
  const float* g;       // z's LayerNorm [N]
  const float* b;
  const bf16* res;      // [M, N] added to the result, or nullptr
  bf16* out;            // [M, N] = bf16([res +] LN^T(acc act'(h) g))
  bf16* act;            // [M, N] = bf16(act(LN z)): e, bb or a
  float* part;          // [3][row tiles][N]: sum dh n, sum dh, sum (res ? res : result)
  int M, L, C, N, taps, dil, gelu, stages;
};

// One data GEMM on Hopper (steps 1-3): the tile of rows m0 + [0, 128) and
// columns n0 + [0, 128) of acc = A W, A the rows [M, C] of dy, cd(dq) or
// cd(dp) (for the transposed conv, tap t's boxes start -(t - (taps - 1) / 2)
// dil rows on: row m reads m + shift), W the weights [C, taps N] as they lie
// (w2 [D, H], wc viewed as [H, K H] at column t H, w1 [H, D]: N-major B
// operands). The producer warp's lane 0 keeps `stages` chunks in flight,
// then asks for the tile of z (q, p or x) in the stage the last chunk
// frees; each consumer warpgroup takes 64 of the rows over every chunk, a
// chain of wgmma m64n128k16 with one chunk in flight while the next is
// issued, zeroing its A rows whose tap row lies in another chain before
// their products. Two blocks share an SM, so that one's epilogue runs under
// the other's products. The epilogue runs over the products put in shared
// memory, in small loops (an unrolled one, per accumulator register, ran
// from instruction-cache misses at several times the products' time), a
// warp a row, four columns a lane: the rows' LayerNorm statistics (given,
// or summed across the cluster, which spans the row tile's column tiles),
// act(LN z) written, dh = acc act'(h), dn = dh g, the rows' sums of dn and
// dn n over all N columns through the cluster's shared memory in rank order,
// out = bf16([res +] LN^T(dn)) with the lane's column partials over the
// warp's rows, then the eight warps' in order.
__global__ void __launch_bounds__(TMA_THREADS, 2)
    wgmma_bytenet_bwd_data_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_w,
                                  const __grid_constant__ CUtensorMap map_z, TmaDataArgs p) {
  constexpr int BN = TMA_BN;
  const DataSmem SM{p.stages};
  const int S = p.stages;
  unsigned char* smem = wg::aligned_smem();
  const unsigned char* zt = smem + Z_STAGE * DataSmem::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM.bars());
  uint64_t* empty = full + S;
  uint64_t* zbar = empty + S;
  float2* sStat = reinterpret_cast<float2*>(smem + SM.stat());  // (mean, 1/sigma)
  float2* sRow = sStat + TMA_BM;
  float2* sMom = sRow + TMA_BM;  // (mean dn, mean dn n)
  float* sG = reinterpret_cast<float*>(smem + SM.par());
  float* sB = sG + BN;
  const hd::bt::DTile<> sD{reinterpret_cast<float*>(smem)};  // dh, over the ring
  float* sCol = reinterpret_cast<float*>(smem);    // [8 warps][3][128], over dh once read
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TMA_BM, L = p.L, M = p.M, N = p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpt = p.C / 64, n_chunks = p.taps * cpt, mid = (p.taps - 1) / 2;
  const int syncs = p.stats ? 2 : 4;  // cluster barriers: one exchange, or two
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      wg::mbar_init(&full[s], 1), wg::mbar_init(&empty[s], TMA_CONSUMERS);
    wg::mbar_init(zbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == TMA_CONSUMERS) {  // the producer: ring position i is stage i % S
    if (lane == 0) {
      wg::tma_prefetch(&map_a);
      wg::tma_prefetch(&map_w);
      wg::tma_prefetch(&map_z);
      int i = 0;
      for (int t = 0, kc = 0; i < n_chunks; ++i) {
        const int s = i % S, row = m0 - (t - mid) * p.dil;
        wg::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = smem + s * DataSmem::STAGE;
        wg::mbar_arrive_expect(&full[s], DataSmem::STAGE);
        wg::tma_load_2d(st, &map_a, &full[s], kc * 64, row);
        wg::tma_load_2d(st + BOX, &map_a, &full[s], kc * 64, row + 64);
        wg::tma_load_2d(st + 2 * BOX, &map_w, &full[s], t * N + n0, kc * 64);
        wg::tma_load_2d(st + 3 * BOX, &map_w, &full[s], t * N + n0 + 64, kc * 64);
        if (++kc == cpt) kc = 0, ++t;
      }
      while (i % S != Z_STAGE) ++i;  // z's position in the ring: once stage Z_STAGE is free
      wg::mbar_wait(&empty[Z_STAGE], ((i / S) & 1) ^ 1);
      wg::mbar_arrive_expect(zbar, 4 * BOX);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wg::tma_load_2d(smem + Z_STAGE * DataSmem::STAGE + k * BOX, &map_z, zbar,
                        n0 + 64 * (k & 1), m0 + 64 * (k >> 1));
    }
    __syncwarp();
    for (int i = 0; i < syncs; ++i) cluster.sync();  // the cluster's barriers count every thread
    return;
  }

  const int grp = warp / TMA_GROUP_WARPS;
  const int g = lane >> 2, t4 = lane & 3, gt = threadIdx.x % 128;
  for (int c = threadIdx.x; c < BN; c += 32 * TMA_CONSUMERS) sG[c] = p.g[n0 + c], sB[c] = p.b[n0 + c];
  if (p.stats)
    for (int r = threadIdx.x; r < TMA_BM; r += 32 * TMA_CONSUMERS)
      sStat[r] = m0 + r < M ? p.stats[m0 + r] : make_float2(0.f, 0.f);

  // The thread's four rows of its group's A box and their positions in their chains
  const int gm0 = m0 + 64 * grp;
  int lpos[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lpos[k] = (gm0 + gt / 8 + 16 * k) % L;
  const int first = gm0 % L;

  float acc[BN / 8][4];
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S, t = c / cpt;
    wg::mbar_wait(&full[s], (c / S) & 1);
    unsigned char* st = smem + s * DataSmem::STAGE;
    const int shift = -(t - mid) * p.dil;
    if (crosses(first, shift, L)) {  // written by threads, read by wgmma
      zero_rows(st + grp * BOX, lpos, shift, L, gt);
      wg::fence_proxy();
      wg::bar_sync(2 + grp, 128);
    }
    const uint64_t da = wg::desc(st + grp * BOX, 0, 1024);
    const uint64_t db = wg::desc(st + 2 * BOX, BOX, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n128<1>(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 2048 * kk),
                         c > 0 || kk > 0);
    wg::commit();
    wg::wait<1>();  // the previous chunk is done
    if (c > 0) release(&empty[(c - 1) % S], lane);
  }
  wg::wait<0>();
  release(&empty[(n_chunks - 1) % S], lane);
  wg::fence_acc(acc);

  // the products into shared memory over the stages before z's, zero past the rows
  wg::bar_sync(1, TMA_CONSUMERS * 32);  // both groups' products are done
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    const bool in = m0 + r < M;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(sD.at(r, 8 * j + 2 * t4)) =
          in ? make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]) : make_float2(0.f, 0.f);
  }
  // the residual's four columns of the warp's rows, its loads all in flight
  // under the passes before its use
  const int c4 = 4 * lane;  // the lane's four columns of a row
  constexpr int WR = TMA_BM / TMA_CONSUMERS;  // rows of a warp: warp + 8 i
  uint2 res[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int m = m0 + warp + TMA_CONSUMERS * i;
    res[i] = p.res && m < M ? *reinterpret_cast<const uint2*>(p.res + (size_t)m * N + n0 + c4)
                            : make_uint2(0, 0);
  }
  wg::mbar_wait(zbar, 0);
  const float4 g4 = *reinterpret_cast<const float4*>(sG + c4);
  const float4 b4 = *reinterpret_cast<const float4*>(sB + c4);
  if (!p.stats) {  // the rows' statistics from z's sums across the cluster
#pragma unroll 1
    for (int r = warp; r < TMA_BM; r += TMA_CONSUMERS) {
      const float4 z = tile4(zt, r, c4);
      const float s = warp_sum(z.x + z.y + z.z + z.w);
      const float s2 = warp_sum(z.x * z.x + z.y * z.y + z.z * z.z + z.w * z.w);
      if (lane == 0) sRow[r] = make_float2(s, s2);
    }
    const float2 tot = hd::bt::cluster_row_sums<TMA_BM>(sRow, cluster);
    if (threadIdx.x < TMA_BM)
      sStat[threadIdx.x] = m0 + (int)threadIdx.x < M ? ln_stats(tot.x, tot.y, N)
                                                     : make_float2(0.f, 0.f);
  }
  wg::bar_sync(1, TMA_CONSUMERS * 32);

  // a warp a row: act(LN z) written; dh = acc act'(h) in place; the row's
  // sums of dn = dh g and of dn n over the tile's columns
#pragma unroll 2
  for (int r = warp; r < TMA_BM; r += TMA_CONSUMERS) {
    const int m = m0 + r;
    const float2 st = sStat[r];
    const float4 z = tile4(zt, r, c4);
    float4* dp = reinterpret_cast<float4*>(sD.at(r, c4));
    float4 d = *dp;
    const float h0 = ln_affine(z.x, st, g4.x, b4.x), h1 = ln_affine(z.y, st, g4.y, b4.y);
    const float h2 = ln_affine(z.z, st, g4.z, b4.z), h3 = ln_affine(z.w, st, g4.w, b4.w);
    if (m < M)
      store4(p.act + (size_t)m * N + n0 + c4, act_fn(h0, p.gelu), act_fn(h1, p.gelu),
             act_fn(h2, p.gelu), act_fn(h3, p.gelu));
    d.x *= dact_fn(h0, p.gelu);
    d.y *= dact_fn(h1, p.gelu);
    d.z *= dact_fn(h2, p.gelu);
    d.w *= dact_fn(h3, p.gelu);
    *dp = d;
    const float dn0 = d.x * g4.x, dn1 = d.y * g4.y, dn2 = d.z * g4.z, dn3 = d.w * g4.w;
    const float s1 = warp_sum(dn0 + dn1 + dn2 + dn3);
    const float s2 = warp_sum(dn0 * ln_norm(z.x, st) + dn1 * ln_norm(z.y, st) +
                              dn2 * ln_norm(z.z, st) + dn3 * ln_norm(z.w, st));
    if (lane == 0) sRow[r] = make_float2(s1, s2);
  }
  {
    const float2 tot = hd::bt::cluster_row_sums<TMA_BM>(sRow, cluster);
    if (threadIdx.x < TMA_BM) sMom[threadIdx.x] = make_float2(tot.x / N, tot.y / N);
  }
  wg::bar_sync(1, TMA_CONSUMERS * 32);

  // a warp a row: out = bf16([res +] LN^T(dn)); the lane's column partials
  // of dh n, dh and (res ? res : the result before rounding) over the warp's
  // rows in order
  float4 pg = make_float4(0.f, 0.f, 0.f, 0.f), pb = pg, pc = pg;
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int r = warp + TMA_CONSUMERS * i, m = m0 + r;
    const float2 st = sStat[r], mo = sMom[r];
    const float4 rr = unpack4(res[i]);
    const float4 z = tile4(zt, r, c4);
    const float4 d = *reinterpret_cast<const float4*>(sD.at(r, c4));
    const float4 n = make_float4(ln_norm(z.x, st), ln_norm(z.y, st), ln_norm(z.z, st),
                                 ln_norm(z.w, st));
    float4 o = make_float4(ln_bwd(d.x * g4.x, n.x, mo.x, mo.y, st.y),
                           ln_bwd(d.y * g4.y, n.y, mo.x, mo.y, st.y),
                           ln_bwd(d.z * g4.z, n.z, mo.x, mo.y, st.y),
                           ln_bwd(d.w * g4.w, n.w, mo.x, mo.y, st.y));
    pg = make_float4(pg.x + d.x * n.x, pg.y + d.y * n.y, pg.z + d.z * n.z, pg.w + d.w * n.w);
    pb = make_float4(pb.x + d.x, pb.y + d.y, pb.z + d.z, pb.w + d.w);
    if (p.res) {
      pc = make_float4(pc.x + rr.x, pc.y + rr.y, pc.z + rr.z, pc.w + rr.w);
      o = make_float4(rr.x + o.x, rr.y + o.y, rr.z + o.z, rr.w + o.w);
    } else {
      pc = make_float4(pc.x + o.x, pc.y + o.y, pc.z + o.z, pc.w + o.w);
    }
    if (m < M) store4(p.out + (size_t)m * N + n0 + c4, o.x, o.y, o.z, o.w);
  }
  wg::bar_sync(1, TMA_CONSUMERS * 32);  // every warp has read dh: its stages take the partials
  *reinterpret_cast<float4*>(sCol + (warp * 3 + 0) * BN + c4) = pg;
  *reinterpret_cast<float4*>(sCol + (warp * 3 + 1) * BN + c4) = pb;
  *reinterpret_cast<float4*>(sCol + (warp * 3 + 2) * BN + c4) = pc;
  wg::bar_sync(1, TMA_CONSUMERS * 32);
  const size_t pstride = (size_t)gridDim.y * N;
  for (int i = threadIdx.x; i < 3 * BN; i += 32 * TMA_CONSUMERS) {
    const int k = i / BN, c = i % BN;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < TMA_CONSUMERS; ++w) t += sCol[(w * 3 + k) * BN + c];
    p.part[k * pstride + (size_t)blockIdx.y * N + n0 + c] = t;
  }
}

// The weight gradients on Hopper (step 4): part[s][P, Q] = X^T Y over the
// rows of split s for three jobs in one launch (dW2 = dy^T e, dWc = cd(dq)^T
// shift_t(bb) at column t H + i, dW1 = cd(dp)^T a), a block a 128 x 128
// tile. A stage: X's rows [64][p0 + 128) as two boxes (the M-major A
// operand, wgmma's transpose-A bit) and Y's [64][q0 + 128) (for dWc tap t's
// box starts shift_t rows on; N-major B). Each consumer warpgroup takes 64
// of the tile's P rows over every chunk (wgmma m64n128k16, one chunk in
// flight while the next is issued); for dWc a group zeroes its A rows whose
// tap row lies in another chain.
struct TmaWJob {
  float* part;  // [splits][P][Q]
  int P, Q, C, taps, first;  // Q = taps C; first: the job's first block
};
struct TmaWArgs {
  TmaWJob job[3];
  int M, L, dil, chunk, stages;  // chunk: rows of a split, a multiple of 64
};
struct WgradMaps {
  CUtensorMap m[6];  // each job's X and Y
};

__global__ void __launch_bounds__(TMA_THREADS, 1)
    wgmma_bytenet_bwd_wgrad_kernel(const __grid_constant__ WgradMaps maps, TmaWArgs a) {
  const WgradSmem SM{a.stages};
  const int S = a.stages;
  unsigned char* smem = wg::aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM.bars());
  uint64_t* empty = full + S;
  const int bx = blockIdx.x;  // the job by selects, not an index into the parameters
  const int j = bx >= a.job[2].first ? 2 : bx >= a.job[1].first ? 1 : 0;
  const TmaWJob jb = j == 2 ? a.job[2] : j == 1 ? a.job[1] : a.job[0];
  const CUtensorMap* mx = j == 2 ? &maps.m[4] : j == 1 ? &maps.m[2] : &maps.m[0];
  const CUtensorMap* my = j == 2 ? &maps.m[5] : j == 1 ? &maps.m[3] : &maps.m[1];
  const int tiles_q = jb.Q / 128, tiles = (jb.P / 128) * tiles_q;
  const int local = bx - jb.first, split = local / tiles, tile = local % tiles;
  const int p0 = (tile / tiles_q) * 128, q0 = (tile % tiles_q) * 128;
  const int t = q0 / jb.C, i0 = q0 - t * jb.C, shift = (t - (jb.taps - 1) / 2) * a.dil;
  const int mb = split * a.chunk, me = min(a.M, mb + a.chunk);
  const int n_chunks = me > mb ? (me - mb + 63) / 64 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      wg::mbar_init(&full[s], 1), wg::mbar_init(&empty[s], TMA_CONSUMERS);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == TMA_CONSUMERS) {  // the producer
    if (lane == 0) {
      wg::tma_prefetch(mx);
      wg::tma_prefetch(my);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % S, k0 = mb + 64 * i;
        wg::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = smem + s * WgradSmem::STAGE;
        wg::mbar_arrive_expect(&full[s], WgradSmem::STAGE);
        wg::tma_load_2d(st, mx, &full[s], p0, k0);
        wg::tma_load_2d(st + BOX, mx, &full[s], p0 + 64, k0);
        wg::tma_load_2d(st + 2 * BOX, my, &full[s], i0, k0 + shift);
        wg::tma_load_2d(st + 3 * BOX, my, &full[s], i0 + 64, k0 + shift);
      }
    }
    return;
  }

  const int grp = warp / TMA_GROUP_WARPS, wq = warp % TMA_GROUP_WARPS;
  const int g = lane >> 2, t4 = lane & 3, gt = threadIdx.x % 128;
  float acc[16][4];
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % S, k0 = mb + 64 * i;
    wg::mbar_wait(&full[s], (i / S) & 1);
    unsigned char* st = smem + s * WgradSmem::STAGE;
    if (crosses(k0 % a.L, shift, a.L)) {  // the group's X rows whose tap row is in another chain
      int lpos[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) lpos[k] = (k0 + gt / 8 + 16 * k) % a.L;
      zero_rows(st + grp * BOX, lpos, shift, a.L, gt);
      wg::fence_proxy();
      wg::bar_sync(2 + grp, 128);
    }
    const uint64_t da = wg::desc(st + grp * BOX, BOX, 1024);
    const uint64_t db = wg::desc(st + 2 * BOX, BOX, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n128<1, 1>(acc, wg::desc_add(da, 2048 * kk), wg::desc_add(db, 2048 * kk),
                            i > 0 || kk > 0);
    wg::commit();
    wg::wait<1>();  // the previous chunk is done
    if (i > 0) release(&empty[(i - 1) % S], lane);
  }
  wg::wait<0>();
  if (n_chunks > 0) release(&empty[(n_chunks - 1) % S], lane);
  if (n_chunks == 0) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
  }
  wg::fence_acc(acc);
  float* dst = jb.part + (size_t)split * jb.P * jb.Q;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pp = p0 + 64 * grp + 16 * wq + g + 8 * hh;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      store2(dst + (size_t)pp * jb.Q + q0 + 8 * jj + 2 * t4, acc[jj][2 * hh],
             acc[jj][2 * hh + 1]);
  }
}

// The transposed-A product alone: d [64, 128] f32 = a^T b for a [64 k][64 m]
// and b [64 k][128 n] bf16 row-major, one warpgroup, the operands written
// into 128-byte-swizzled shared memory by the threads
__global__ void __launch_bounds__(128) trans_a_probe_kernel(const bf16* a, const bf16* b,
                                                            float* d) {
  unsigned char* s = wg::aligned_smem();
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    *reinterpret_cast<bf16*>(s + wg::swizzle128(i / 64, i % 64)) = a[i];
  for (int i = threadIdx.x; i < 64 * 128; i += 128)
    *reinterpret_cast<bf16*>(s + BOX + (i % 128 / 64) * BOX + wg::swizzle128(i / 128, i % 64)) =
        b[i];
  wg::fence_proxy();
  __syncthreads();
  float acc[16][4];
  const uint64_t da = wg::desc(s, BOX, 1024), db = wg::desc(s + BOX, BOX, 1024);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::mma_m64n128<1, 1>(acc, wg::desc_add(da, 2048 * kk), wg::desc_add(db, 2048 * kk), kk > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(acc);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      store2(d + (16 * w + g + 8 * hh) * 128 + 8 * jj + 2 * t4, acc[jj][2 * hh],
             acc[jj][2 * hh + 1]);
}

// Each Hopper kernel's limit on dynamic shared memory, set once (the first
// call of a process is eager: a graph capture sets nothing)
cudaError_t tma_limits() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(wgmma_bytenet_bwd_data_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DataSmem{DATA_STAGES}.bytes());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(wgmma_bytenet_bwd_wgrad_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                WgradSmem{WGRAD_STAGES[1]}.bytes());
  }();
  return err;
}

bool one_of(long long v, const int (&set)[2]) { return v == set[0] || v == set[1]; }

// The plan of one call as the caller computed it
// (ops/fused_bytenet.py::bytenet_block_backward_plan), PLAN_LEN values:
// the workspace's bytes, the splits and rows of a split; for each data GEMM
// (de, dbb, da) grid x, y, cluster x, threads, shared memory, stages; the
// weight-gradient launch's blocks, threads, shared memory, stages; the sum's
// blocks, jobs, threads; the N_MAPS tensor maps (columns, rows, row bytes,
// box columns, box rows) of dy, w2, q, dq, wc, p, dp, w1, x, e, bb, a. Only
// the splits and the weight gradients' stages are choices; the rest
// follows from the shape.
bool own_plan(const long long* plan, int B, int L, int D, int H, int K, Layout* t) {
  const long long M = (long long)B * L, rt = (M + TMA_BM - 1) / TMA_BM;
  const long long splits = plan[1];
  if (splits < 1 || splits > (M + 63) / 64) return false;
  const int chunk = split_rows(M, (int)splits);
  *t = layout_of(M, D, H, K, 2, (int)rt, (int)rt, (int)((M + chunk - 1) / chunk), chunk);
  long long want[PLAN_LEN];
  want[0] = (long long)t->bytes;
  want[1] = t->splits;
  want[2] = chunk;
  const int cols[3] = {H, H, D};
  for (int i = 0; i < 3; ++i) {
    const long long w[6] = {cols[i] / TMA_BN, rt, cols[i] / TMA_BN, TMA_THREADS,
                            DataSmem{DATA_STAGES}.bytes(), DATA_STAGES};
    for (int k = 0; k < 6; ++k) want[3 + 6 * i + k] = w[k];
  }
  const long long wst = plan[24];
  if (!one_of(wst, WGRAD_STAGES)) return false;
  const long long tiles = wgrad_tiles(D, H) + wgrad_tiles(H, K * H) + wgrad_tiles(H, D);
  want[21] = tiles * t->splits;
  want[22] = TMA_THREADS;
  want[23] = WgradSmem{(int)wst}.bytes();
  want[24] = wst;
  want[25] = sum_blocks(D, H, K);
  want[26] = SUM_JOBS;
  want[27] = 256;
  const long long shapes[N_MAPS][2] = {{D, M}, {H, D}, {H, M}, {H, M}, {K * H, H}, {H, M},
                                       {H, M}, {D, H}, {D, M}, {H, M}, {H, M}, {D, M}};
  for (int k = 0; k < N_MAPS; ++k) {
    const long long w[5] = {shapes[k][0], shapes[k][1], shapes[k][0] * 2, 64, 64};
    for (int i = 0; i < 5; ++i) want[28 + 5 * k + i] = w[i];
  }
  for (int i = 0; i < PLAN_LEN; ++i)
    if (plan[i] != want[i]) return false;
  return want[3 + 2] <= MAX_CLUSTER && want[15 + 2] <= MAX_CLUSTER &&
         want[3 + 4] <= TMA_MAX_SMEM && want[23] <= TMA_MAX_SMEM;
}

cudaError_t launch_data(const long long* lp, const CUtensorMap& ma, const CUtensorMap& mw,
                        const CUtensorMap& mz, TmaDataArgs args, cudaStream_t stream) {
  args.stages = (int)lp[5];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lp[0], (unsigned)lp[1], 1);
  cfg.blockDim = dim3((unsigned)lp[3]);
  cfg.dynamicSmemBytes = (size_t)lp[4];
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)lp[2];
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  void* params[4] = {const_cast<CUtensorMap*>(&ma), const_cast<CUtensorMap*>(&mw),
                     const_cast<CUtensorMap*>(&mz), &args};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, (const void*)wgmma_bytenet_bwd_data_kernel, params);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int launch_tma(const bf16* x, const bf16* p, const bf16* q, const float2* stats,
               const float* const* prm, const bf16* w1, const bf16* wc, const bf16* w2,
               const bf16* dy, bf16* dx, const Grads& gr, unsigned char* ws, int B, int L, int D,
               int H, int K, int dil, int gelu, const long long* plan, cudaStream_t stream,
               int* launched) {
  Layout t;
  if (!own_plan(plan, B, L, D, H, K, &t)) return (int)cudaErrorInvalidValue;
  cudaError_t err = tma_limits();
  if (err != cudaSuccess) return (int)err;
  const int M = B * L;
  bf16* dq = reinterpret_cast<bf16*>(ws + t.dq);
  bf16* dp = reinterpret_cast<bf16*>(ws + t.dp);
  bf16* e = reinterpret_cast<bf16*>(ws + t.e);
  bf16* bb = reinterpret_cast<bf16*>(ws + t.bb);
  bf16* a = reinterpret_cast<bf16*>(ws + t.a);
  const void* bases[N_MAPS] = {dy, w2, q, dq, wc, p, dp, w1, x, e, bb, a};
  CUtensorMap maps[N_MAPS];
  for (int k = 0; k < N_MAPS; ++k) {
    const long long* m = plan + 28 + 5 * k;
    if (reinterpret_cast<uintptr_t>(bases[k]) % 16) return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {(cuuint64_t)m[0], (cuuint64_t)m[1]};
    const cuuint64_t strides[1] = {(cuuint64_t)m[2]};
    const cuuint32_t box[2] = {(cuuint32_t)m[3], (cuuint32_t)m[4]};
    if (!wg::encode(&maps[k], bases[k], 2, dims, strides, box)) return (int)cudaErrorInvalidValue;
  }
  const float2* sx = stats;
  const float2* sp = stats ? stats + M : nullptr;
  const float2* sq = stats ? stats + 2 * (size_t)M : nullptr;
  float* col1 = reinterpret_cast<float*>(ws + t.col1);
  float* col2 = reinterpret_cast<float*>(ws + t.col2);
  float* col3 = reinterpret_cast<float*>(ws + t.col3);
  const TmaDataArgs d1{sq, prm[6], prm[7], nullptr, dq, e, col1, M, L, D, H, 1, 0, gelu, 0};
  const TmaDataArgs d2{sp, prm[3], prm[4], nullptr, dp, bb, col2, M, L, H, H, K, dil, gelu, 0};
  const TmaDataArgs d3{sx, prm[0], prm[1], dy, dx, a, col3, M, L, H, D, 1, 0, gelu, 0};
#define HD_STEP(call)                                 \
  if ((err = (call)) != cudaSuccess) return (int)err; \
  ++*launched;
  HD_STEP(launch_data(plan + 3, maps[0], maps[1], maps[2], d1, stream));
  HD_STEP(launch_data(plan + 9, maps[3], maps[4], maps[5], d2, stream));
  HD_STEP(launch_data(plan + 15, maps[6], maps[7], maps[8], d3, stream));
  TmaWArgs wa{{{reinterpret_cast<float*>(ws + t.w2p), D, H, H, 1, 0},
               {reinterpret_cast<float*>(ws + t.wcp), H, K * H, H, K, 0},
               {reinterpret_cast<float*>(ws + t.w1p), H, D, D, 1, 0}},
              M, L, dil, t.chunk, (int)plan[24]};
  wa.job[1].first = wgrad_tiles(D, H) * t.splits;
  wa.job[2].first = wa.job[1].first + wgrad_tiles(H, K * H) * t.splits;
  WgradMaps wm{{maps[0], maps[9], maps[3], maps[10], maps[6], maps[11]}};
  {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)plan[21]);
    cfg.blockDim = dim3((unsigned)plan[22]);
    cfg.dynamicSmemBytes = (size_t)plan[23];
    cfg.stream = stream;
    void* params[2] = {&wm, &wa};
    err = cudaLaunchKernelExC(&cfg, (const void*)wgmma_bytenet_bwd_wgrad_kernel, params);
    HD_STEP(err != cudaSuccess ? err : cudaGetLastError());
  }
  HD_STEP(sum_all(gr, t, ws, D, H, K, stream));
#undef HD_STEP
  return 0;
}

bool bad_shape(int B, int L, int D, int H, int K, int dil, int act) {
  return B <= 0 || L <= 0 || D <= 0 || H <= 0 || D % 32 || H % 32 || D > 1024 || H > 1024 ||
         K <= 0 || K % 2 == 0 || dil <= 0 || (act != 0 && act != 1) ||
         (long long)B * L > (1LL << 30) / D;
}

}  // namespace

// Bytes of workspace hd_bytenet_block_bwd needs (0 for an invalid shape).
extern "C" long long hd_bytenet_block_bwd_workspace(int B, int L, int D, int H, int K,
                                                    int dtype) {
  if (bad_shape(B, L, D, H, K, 1, 0) || (dtype != 0 && dtype != 1)) return 0;
  return (long long)layout(B, L, D, H, K, dtype == 0 ? 4 : 2).bytes;
}

// x, dy, dx [B, L, D] and p, q [B, L, H] in the activation type; stats the
// forward's LayerNorm statistics of x, p and q rows ([3][B*L] f32 (mean,
// 1/sigma) pairs, as hd_bytenet_block_fwd writes them) or null, when K4
// takes them from the rows itself; w1 [H, D],
// wc [H, K, H] ([out][tap][in]), w2 [D, H] in the activation type too (the
// forward's copies); g1, b1 [D], c1, g2, b2 [H], cc, g3, b3 [H], c2 [D] f32
// (the biases c1, cc, c2 are not read); the 12 gradients f32, in the
// parameters' shapes, written whole; workspace of
// hd_bytenet_block_bwd_workspace bytes. D and H multiples of 32 up to 1024,
// K odd. dtype 0 = float32, 1 = bfloat16; act 0 = ReLU, 1 = GELU. Sets
// *launched to the number of kernels launched (5 on success) and returns a
// cudaError_t code (0 = all launched).
extern "C" int hd_bytenet_block_bwd(
    const void* x, const void* p, const void* q, const void* stats, const void* g1, const void* b1,
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
  const float* prm[9] = {f(g1), f(b1), f(c1), f(g2), f(b2), f(cc), f(g3), f(b3), f(c2)};
  const Grads gr{o(dg1), o(db1), o(dw1), o(dc1), o(dg2), o(db2),
                 o(dwc), o(dcc), o(dg3), o(db3), o(dw2), o(dc2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<unsigned char*>(workspace);
  auto st = static_cast<const float2*>(stats);
  if (dtype == 0)
    return launch<float>(f(x), f(p), f(q), st, prm, f(w1), f(wc), f(w2), f(dy),
                         static_cast<float*>(dx), gr, ws, B, L, D, H, K, dil, act, s, launched);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    auto h = [](const void* v) { return static_cast<const bf16*>(v); };
    return launch<bf16>(h(x), h(p), h(q), st, prm, h(w1), h(wc), h(w2), h(dy),
                        static_cast<bf16*>(dx), gr, ws, B, L, D, H, K, dil, act, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}

// K4 on Hopper: bf16, D and H multiples of 128 up to 1024 (the shapes
// ops/fused_bytenet.py::bytenet_block_backward_plan gives this path).
// Arguments as hd_bytenet_block_bwd's, without dtype; x, p, q, dy, the
// weights and the workspace at 16-byte aligned addresses (TMA); the
// workspace of plan[0] bytes; `plan` the call's PLAN_LEN values, refused
// unless they are this source's own. Sets *launched to the kernels
// launched (5 on success) and returns a cudaError_t code (0 = all launched).
extern "C" int hd_bytenet_block_bwd_tma(
    const void* x, const void* p, const void* q, const void* stats, const void* g1, const void* b1,
    const void* w1, const void* c1, const void* g2, const void* b2, const void* wc,
    const void* cc, const void* g3, const void* b3, const void* w2, const void* c2,
    const void* dy, void* dx, void* dg1, void* db1, void* dw1, void* dc1, void* dg2,
    void* db2, void* dwc, void* dcc, void* dg3, void* db3, void* dw2, void* dc2,
    void* workspace, int B, int L, int D, int H, int K, int dil, int act,
    const long long* plan, void* stream, int* launched) {
  *launched = 0;
  if (bad_shape(B, L, D, H, K, dil, act) || D % TMA_BN || H % TMA_BN ||
      reinterpret_cast<uintptr_t>(workspace) % 256)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto o = [](void* v) { return static_cast<float*>(v); };
  auto h = [](const void* v) { return static_cast<const bf16*>(v); };
  const float* prm[9] = {f(g1), f(b1), f(c1), f(g2), f(b2), f(cc), f(g3), f(b3), f(c2)};
  const Grads gr{o(dg1), o(db1), o(dw1), o(dc1), o(dg2), o(db2),
                 o(dwc), o(dcc), o(dg3), o(db3), o(dw2), o(dc2)};
  return launch_tma(h(x), h(p), h(q), static_cast<const float2*>(stats), prm, h(w1), h(wc),
                    h(w2), h(dy), static_cast<bf16*>(dx), gr,
                    static_cast<unsigned char*>(workspace), B, L, D, H, K, dil, act, plan,
                    static_cast<cudaStream_t>(stream), launched);
}

// The transposed-A wgmma alone (trans_a_probe_kernel): d [64, 128] f32 =
// a^T b for bf16 a [64, 64] and b [64, 128], row-major, on the card; returns
// a cudaError_t code
extern "C" int hd_wgmma_trans_a_probe(const void* a, const void* b, void* d, void* stream) {
  trans_a_probe_kernel<<<1, 128, 3 * BOX + wg::SMEM_SLACK, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(d));
  return (int)cudaGetLastError();
}

// How the Hopper K4's launches of `plan` fit the card: out[0..2] the data
// GEMMs' clusters that can be resident at once (cudaOccupancyMaxActiveClusters),
// out[3] the weight-gradient blocks an SM; returns a cudaError_t code
extern "C" int hd_bytenet_block_bwd_occupancy(const long long* plan, int* out) {
  cudaError_t err = tma_limits();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 3; ++i) {
    const long long* lp = plan + 3 + 6 * i;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)lp[0], (unsigned)lp[1], 1);
    cfg.blockDim = dim3((unsigned)lp[3]);
    cfg.dynamicSmemBytes = (size_t)lp[4];
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)lp[2];
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    if ((err = cudaOccupancyMaxActiveClusters(&out[i], (const void*)wgmma_bytenet_bwd_data_kernel,
                                              &cfg)) != cudaSuccess)
      return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], wgmma_bytenet_bwd_wgrad_kernel, (int)plan[22], (size_t)plan[23]);
}
