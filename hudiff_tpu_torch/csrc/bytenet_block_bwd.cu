// K4: backward of the ByteNet residual block (K2), as five launches.
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
// Design (gemm_tiles.cuh's pipelined core). The TPU kernel accumulated the 12
// parameter gradients across its sequential batch-tile grid; on Hopper they
// are reductions over the B*L rows (19,456 at B=128) across blocks that run
// in no order, done as fixed-order two-step sums with no atomics, so a call
// repeats to the same bits:
//   1-3. bytenet_bwd_data_kernel: de = dy W2, dbb = conv^T(dq) Wc, da = dp W1.
//        A block owns whole rows (up to 1024 columns: 8 warps side by side,
//        BM = 64, 32 or 16 rows by width), so the LayerNorm backward runs in
//        its epilogue: once the ring is drained, the block puts its rows of
//        the LayerNorm's input z (q, p or x, one cp.async batch) and its
//        accumulator in shared memory, and loops over them: a warp a row
//        takes the row's LN statistics (or reads the forward's, which K2
//        writes as residuals, so that both passes make the same ReLU
//        decisions), writes act(LN z) (e, bb or a: the
//        other operand of step 4, so that step forms nothing) and dq, dp or
//        dx; a thread a column sums the block's partials of the LN parameter
//        and bias gradients. de, dbb and da never reach device memory. The
//        conv-transposed operand gathers row m - shift_t of the chain.
//   4.   bytenet_bwd_wgrad_kernel: the three weight gradients in one grouped
//        launch, 128 x 128 tiles, the rows split into chunks with an f32
//        partial each; bb is gathered per tap, zero outside the chain.
//   5.   bytenet_bwd_sum_kernel: every partial summed in a fixed order (a
//        warp a value where there are many partials).
// The weights arrive in cd (the forward's copies), so no block rounds a
// weight. Wide rows (more than 384 columns) stage 64-byte chunks so that
// three slots fit in shared memory. The port has no length padding: rows
// outside a chain read as zeros, which is what the TPU kernel's row masks
// (_row_mask) achieve on its padded rows. f32 inputs take the FMA path of
// the same kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_tiles.cuh"

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
  int nb1, nb3;       // data-GEMM blocks: of H columns (steps 1, 2), of D (step 3)
  int chunk, splits;  // weight gradients: rows of a split, splits
};

Layout layout(int B, int L, int D, int H, int K, size_t cd) {
  Layout t;
  const size_t M = (size_t)B * L;
  t.nb1 = (int)((M + data_bm(data_ntw(H)) - 1) / data_bm(data_ntw(H)));
  t.nb3 = (int)((M + data_bm(data_ntw(D)) - 1) / data_bm(data_ntw(D)));
  const int tiles = wgrad_tiles(D, H) + wgrad_tiles(H, K * H) + wgrad_tiles(H, D);
  int splits = (WGRAD_TARGET + tiles - 1) / tiles;
  const int most = (int)((M + WGRAD_MIN_ROWS - 1) / WGRAD_MIN_ROWS);
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  t.chunk = (int)(((M + splits - 1) / splits + 63) / 64 * 64);
  t.splits = (int)((M + t.chunk - 1) / t.chunk);
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

struct Grads { float *g1, *b1, *w1, *c1, *g2, *b2, *wc, *cc, *g3, *b3, *w2, *c2; };

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
  float* col1 = reinterpret_cast<float*>(ws + t.col1);  // [3][nb1][H]: g3, b3, cc
  float* col2 = reinterpret_cast<float*>(ws + t.col2);  // [3][nb1][H]: g2, b2, c1
  float* col3 = reinterpret_cast<float*>(ws + t.col3);  // [3][nb3][D]: g1, b1, c2
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

  const size_t nh = (size_t)t.nb1 * H, nd = (size_t)t.nb3 * D;
  SumJobs sj{{{w2p, gr.w2, t.splits, D * H},
              {wcp, gr.wc, t.splits, H * K * H},
              {w1p, gr.w1, t.splits, H * D},
              {col1, gr.g3, t.nb1, H}, {col1 + nh, gr.b3, t.nb1, H},
              {col1 + 2 * nh, gr.cc, t.nb1, H},
              {col2, gr.g2, t.nb1, H}, {col2 + nh, gr.b2, t.nb1, H},
              {col2 + 2 * nh, gr.c1, t.nb1, H},
              {col3, gr.g1, t.nb3, D}, {col3 + nd, gr.b1, t.nb3, D},
              {col3 + 2 * nd, gr.c2, t.nb3, D}}};
  const int widest = H * K * H > D * H ? H * K * H : D * H;
  const int sum_blocks = (widest + 255) / 256 < SUM_BLOCKS ? (widest + 255) / 256 : SUM_BLOCKS;
  bytenet_bwd_sum_kernel<<<dim3(sum_blocks, SUM_JOBS), 256, 0, stream>>>(sj);
  HD_STEP(cudaGetLastError());
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
