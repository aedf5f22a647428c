// K2: the ByteNet residual block forward, as three launches, one GEMM each,
// with every LayerNorm + activation folded into a GEMM, in two designs.
//
// Replaces hudiff_tpu/ops/pallas_bytenet.py::_fwd_kernel (called through
// _pallas_fwd / bytenet_block_fused).
//
// What it computes, with LN = f32 LayerNorm (eps 1e-6, var = E[x^2] - E[x]^2),
// act = ReLU or exact-erf GELU, and cd = the activation type:
//   p = cd(act(LN1 x) W1 + c1)
//   q = cd(dilconv(bb) + cc),  bb = cd(act(LN2 p)), zero outside the chain
//   y = cd(x + act(LN3 q) W2 + c2)
// Matmul inputs are in cd, accumulation in f32.
//
// What bounds it on an H100: operations. For the 768/384 dual-tower block at
// B=64, L=152 one forward is about 31.5 GFLOP (32 us at 989 TFLOP/s bf16)
// against about 30 MB of activations (9 us at 3.35 TB/s). At the sampler's
// B=16 the three GEMMs are small (2,432 rows): each block's chain of
// dependent chunks (42 for the conv at H = 384), its epilogue and the
// launches are what cost.
//
// Hopper design (bf16, D and H multiples of 128: wgmma_bytenet_fwd_gemm_kernel;
// wgmma_tiles.cuh), the same three GEMMs and rounding points: a block takes
// a 64 x 128 tile of the B*L rows and a GEMM's columns. A producer warp
// keeps a ring of 8 (or 4) stages full by TMA, each an A box (64 rows x 64
// channels, 128-byte swizzle: rows past the ends are TMA's zeros) and the
// tile's 128 weight rows of the same channels (the weights are K-major B
// operands as they lie, [N][taps * C]); the F2 tap t box starts (t - (K -
// 1) / 2) dil rows on. Two consumer warpgroups split the chunks, even and
// odd, each a chain of wgmma m64n128k16 from shared memory with the next
// chunk issued before the last is waited on: the chain a block waits on is
// half the reduction, with twice the blocks a 128-row tile would give.
// Where a landed box must change, the group that reads it rewrites it in
// place (then a proxy fence and a group barrier): F1's x becomes bf16(act(
// LN1 x)), LN1's statistics taken first from a pass of x's chunks through
// the same ring; F2 zeroes the rows whose tap row lies in another chain
// (the conv's padding; pallas_bytenet.py:174-178), only in tiles that have
// such rows. The two partial sums meet in shared memory, each group adding
// the other's half of the columns to its own in one order, so both round
// alike; each group finishes its 64 columns (bias, residual, rounding) and
// F1 and F2, launched as clusters over a row tile's column tiles, take the
// next LayerNorm's statistics through distributed shared memory, in rank
// order. Parameters the epilogue reads sit in shared memory and the
// residual's loads are issued together (with each load waiting for the
// last store an epilogue took 7-8 us). ops/fused_bytenet.py::
// bytenet_block_plan computes every launch (grid, cluster, stages, tensor
// maps) and the entry refuses any other; it takes this path for the 768/384
// and 512/256 towers up to 528 conv tiles (B <= 64 at L = 152), where it
// read faster than the cp.async + mma.sync design below on an H100.
//
// The cp.async + mma.sync design (the rest: f32, widths that are not multiples of 128, the
// 256/128 tower, larger batches; gemm_tiles.cuh's pipelined core; one
// kernel, bytenet_fwd_gemm_kernel):
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace hd::gemm;
namespace tc = hd::tc;
namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

template <typename T> struct FwdArgs {
  const T* a;         // operand rows [M, C]: x, bb or e
  const T* w;         // [N, taps * C] row-major
  const float* bias;  // [N]
  const float* g;     // F1: LayerNorm 1 of the operand rows [C]
  const float* b;
  const T* res;       // residual [M, N] or nullptr
  T* out;             // [M, N], or nullptr: not kept
  const float* g_out; // F1, F2: the next LayerNorm [N], or nullptr
  const float* b_out;
  T* act_out;         // [M, N] = cd(act(LN(cd(out)))), when g_out is set
  float2* stats_a;    // F1: out, LN1's (mean, 1/sigma) of the A rows [M], or nullptr
  float2* stats_out;  // F1, F2: out, the next LayerNorm's of out's rows [M], or nullptr
  int M, C, N, L, taps, dil, gelu;
};

template <typename T, int BM, int BN> struct FwdTile {
  static constexpr int V = VEC<T>, BK = 128 / (int)sizeof(T);  // swizzled 128-byte rows
  static constexpr int WM = BM / 2, WN = BN / 4;  // 2 x 4 warps
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_SLOT = BM * BK, B_SLOT = BN * BK;
  using Layout = Swz<BK>;
  // the ring, the rows' LN1 statistics [BM], the row sums of 4 column warps
  // [4][BM] and the block's row sums [BM]
  static constexpr size_t SMEM =
      (size_t)STAGES * (A_SLOT + B_SLOT) * sizeof(T) + (size_t)6 * BM * sizeof(float2);
};

// the operand policy: gathered A rows (with LN1 + activation on landing when
// LN_A), B rows. Chunks are issued in order, so the next chunk's tap and
// depth are counters, and a thread's A rows (the same every chunk) keep
// their position in the chain: no division in the loop.
template <typename T, int BM, int BN, bool LN_A> struct FwdOp {
  using Tl = FwdTile<T, BM, BN>;
  static constexpr bool TRANSFORM = LN_A;
  static constexpr int W = Tl::BK / Tl::V;  // vectors of a chunk row
  static constexpr int RA = BM * W / THREADS, RB = BN * W / THREADS;  // a thread's rows
  static_assert(BM * W % THREADS == 0 && BN * W % THREADS == 0, "whole rows per pass");
  const FwdArgs<T>& p;
  T* sA;
  T* sB;
  const float2* sStat;  // [BM]: (mean, 1/sigma), 1/sigma < 0 for no row
  int m0, n0, cpt;      // chunks per tap
  typename Tl::Layout lay;
  int t, kc;            // the next chunk's tap and chunk within the tap
  int la[RA];           // a thread's A rows: position in the chain, -1 past M

  static __device__ __forceinline__ int row(int i) {
    return (int)threadIdx.x / W + i * (THREADS / W);
  }
  __device__ __forceinline__ void init() {
    t = kc = 0;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int m = m0 + row(i);
      la[i] = m < p.M ? m % p.L : -1;
    }
  }
  __device__ __forceinline__ void issue(int, int slot) {
    const int v = threadIdx.x % W, ch = kc * Tl::BK + v * Tl::V;
    const int s = (t - (p.taps - 1) / 2) * p.dil;  // row m reads row m + s
    T* a_dst = sA + slot * Tl::A_SLOT;
    T* b_dst = sB + slot * Tl::B_SLOT;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int r = row(i), l = la[i] + s;
      const bool ok = la[i] >= 0 && l >= 0 && l < p.L && ch < p.C;
      tc::cp_async16(a_dst + lay.at(r, v * Tl::V),
                     ok ? p.a + (size_t)(m0 + r + s) * p.C + ch : p.a, ok);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = row(i), n = n0 + r;
      const bool ok = n < p.N && ch < p.C;
      tc::cp_async16(b_dst + lay.at(r, v * Tl::V),
                     ok ? p.w + ((size_t)n * p.taps + t) * p.C + ch : p.w, ok);
    }
    if (++kc == cpt) {
      kc = 0;
      ++t;
    }
  }
  __device__ __forceinline__ void transform(int c, int slot) {
    const int k0 = (c % cpt) * Tl::BK;
    T* a_dst = sA + slot * Tl::A_SLOT;
    for_vectors<BM, W>([&](int r, int v) {
      const int ch = k0 + v * Tl::V;
      const float2 st = sStat[r];
      const bool ok = st.y >= 0.f && ch < p.C;
      ln_act_vec(a_dst + lay.at(r, v * Tl::V), st, p.g + (ok ? ch : 0), p.b + (ok ? ch : 0),
                 p.gelu, ok);
    });
  }
};

// out = cd([res +] A' W^T + bias) for one BM x BN tile, A' = act(LN1 A) when
// LN_A, else A gathered per tap; with g_out set, the launch is a cluster
// over the row tile's column tiles and act_out = cd(act(LN(out))) too
template <typename T, int BM, int BN, bool LN_A>
__global__ void __launch_bounds__(THREADS, BM == 128 ? 2 : 1) bytenet_fwd_gemm_kernel(FwdArgs<T> p) {
  using Tl = FwdTile<T, BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * Tl::A_SLOT;
  float2* sStat = reinterpret_cast<float2*>(sB + STAGES * Tl::B_SLOT);  // [BM]
  float2* sRed = sStat + BM;                                            // [4][BM]
  float2* sRow = sRed + 4 * BM;                                         // [BM]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if constexpr (LN_A) {  // LN1's statistics of the block's rows, eight rows a warp at once
    constexpr int R = 8;
    for (int r0 = 0; r0 < BM; r0 += R * (THREADS / 32)) {
      const T* rows[R];
      float2 st[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int m = m0 + r0 + warp + 8 * k;
        rows[k] = m < p.M ? p.a + (size_t)m * p.C : nullptr;
      }
      rows_stats(rows, p.C, lane, st);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          sStat[r0 + warp + 8 * k] = rows[k] ? st[k] : make_float2(0.f, -1.f);
          if (rows[k] && p.stats_a && blockIdx.y == 0) p.stats_a[m0 + r0 + warp + 8 * k] = st[k];
        }
    }
    __syncthreads();
  }

  const typename Tl::Layout lay{};
  FwdOp<T, BM, BN, LN_A> op{p, sA, sB, sStat, m0, n0, (p.C + Tl::BK - 1) / Tl::BK, lay};
  op.init();
  float acc[Tl::MT][Tl::NT][4];
  zero(acc);
  const int wm = (warp / 4) * Tl::WM, wn = (warp % 4) * Tl::WN;
  mainloop<T, Tl::MT, Tl::NT, Tl::BK, false, false>(acc, op, p.taps * op.cpt, sA, Tl::A_SLOT,
                                                    lay, sB, Tl::B_SLOT, lay, wm, wn, lane);

  // epilogue: bias, residual, rounding (kept in acc); the rounded values' row sums
  const int g = lane >> 2, tq = lane & 3;
  float rs[Tl::MT][2][2];  // [m-tile][row half]: sum, sum of squares
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[i][h][0] = rs[i][h][1] = 0.f;
      const int m = m0 + wm + 16 * i + g + 8 * h;
#pragma unroll
      for (int j = 0; j < Tl::NT; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tq;
        if (m < p.M && col < p.N) {
          float v0 = acc[i][j][2 * h] + p.bias[col], v1 = acc[i][j][2 * h + 1] + p.bias[col + 1];
          if (p.res) {
            const float2 r = load2(p.res + (size_t)m * p.N + col);
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          v0 = to_f(from_f<T>(v0));
          v1 = to_f(from_f<T>(v1));
          if (p.out) store2(p.out + (size_t)m * p.N + col, v0, v1);
          acc[i][j][2 * h] = v0;
          acc[i][j][2 * h + 1] = v1;
          rs[i][h][0] += v0 + v1;
          rs[i][h][1] += v0 * v0 + v1 * v1;
        }
      }
    }
  if (!p.g_out) return;

  // the full rows' statistics: the four lanes of a row, the 4 column warps
  // in order, then every block of the cluster in rank order
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs[i][h][k] += __shfl_xor_sync(0xffffffffu, rs[i][h][k], 1);
        rs[i][h][k] += __shfl_xor_sync(0xffffffffu, rs[i][h][k], 2);
      }
      if (tq == 0)
        sRed[(warp % 4) * BM + wm + 16 * i + g + 8 * h] = make_float2(rs[i][h][0], rs[i][h][1]);
    }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    float2 s = sRed[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      s.x += sRed[w * BM + r].x;
      s.y += sRed[w * BM + r].y;
    }
    sRow[r] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sRow is written
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    float s = 0.f, s2 = 0.f;
    for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
      const float2 v = *cluster.map_shared_rank(sRow + r, k);
      s += v.x;
      s2 += v.y;
    }
    sStat[r] = ln_stats(s, s2, p.N);
    if (p.stats_out && blockIdx.y == 0 && m0 + r < p.M) p.stats_out[m0 + r] = sStat[r];
  }
  cluster.sync();  // every block has read the others' sRow; sStat is written

  // act_out = cd(act(LN(out))) from the rounded values in acc
#pragma unroll
  for (int j = 0; j < Tl::NT; ++j) {
    const int col = n0 + wn + 8 * j + 2 * tq;
    if (col >= p.N) continue;
    const float2 gc = load2(p.g_out + col), bc = load2(p.b_out + col);
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h, m = m0 + r;
        if (m >= p.M) continue;
        const float2 st = sStat[r];
        store2(p.act_out + (size_t)m * p.N + col,
               act_fn(ln_affine(acc[i][j][2 * h], st, gc.x, bc.x), p.gelu),
               act_fn(ln_affine(acc[i][j][2 * h + 1], st, gc.y, bc.y), p.gelu));
      }
  }
}

template <typename T, int BM, int BN, bool LN_A>
cudaError_t gemm_tiled(const FwdArgs<T>& a, cudaStream_t stream) {
  auto kernel = bytenet_fwd_gemm_kernel<T, BM, BN, LN_A>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FwdTile<T, BM, BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = FwdTile<T, BM, BN>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = a.g_out ? grid.y : 1;  // a row tile's column tiles
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// 128 x 128 tiles where they still give two blocks per SM of an H100, or
// where 64-column tiles would make a cluster larger than the portable size;
// else 64 x 64
bool big_tiles(int M, int N, bool cluster) {
  return (long long)((M + 127) / 128) * ((N + 127) / 128) >= 2 * 132 ||
         (cluster && N > 64 * MAX_CLUSTER);
}

template <typename T, bool LN_A> cudaError_t gemm(const FwdArgs<T>& a, cudaStream_t stream) {
  return big_tiles(a.M, a.N, a.g_out != nullptr) ? gemm_tiled<T, 128, 128, LN_A>(a, stream)
                                                 : gemm_tiled<T, 64, 64, LN_A>(a, stream);
}

template <typename T>
int launch(const T* x, const float* const* prm, const T* w1, const T* wc, const T* w2, T* p,
           T* q, T* y, T* bb, T* e, float2* stats, int B, int L, int D, int H, int K, int dil,
           int gelu, cudaStream_t stream, int* launched) {
  // prm: g1, b1, c1, g2, b2, cc, g3, b3, c2 (f32); stats: [3][M] (x, p, q) or nullptr
  const int M = B * L;
  float2* st1 = stats;
  float2* st2 = stats ? stats + M : nullptr;
  float2* st3 = stats ? stats + 2 * (size_t)M : nullptr;
  const FwdArgs<T> f1{x, w1, prm[2], prm[0], prm[1], nullptr, p, prm[3], prm[4], bb, st1, st2,
                      M, D, H, L, 1, 0, gelu};
  const FwdArgs<T> f2{bb, wc, prm[5], nullptr, nullptr, nullptr, q, prm[6], prm[7], e, nullptr,
                      st3, M, H, H, L, K, dil, gelu};
  const FwdArgs<T> f3{e, w2, prm[8], nullptr, nullptr, x, y, nullptr, nullptr, nullptr, nullptr,
                      nullptr, M, H, D, L, 1, 0, gelu};
  cudaError_t err;
  // *launched counts the kernels that were launched, in order
  if ((err = gemm<T, true>(f1, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = gemm<T, false>(f2, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = gemm<T, false>(f3, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// ---- bf16, widths multiples of 128: wgmma fed by TMA (Hopper) ---------------

namespace wg = hd::wg;

constexpr int TMA_BM = 64;                  // rows of a tile
constexpr int TMA_BN = 128;                 // columns of a tile
constexpr int TMA_GROUP_WARPS = 4;          // a consumer warpgroup; two split the chunks
constexpr int TMA_CONSUMERS = 2 * TMA_GROUP_WARPS;
constexpr int TMA_THREADS = (TMA_CONSUMERS + 1) * 32;  // and one producer warp
constexpr int TMA_MAX_C = 1024;             // F1: LayerNorm 1's g and b held in shared memory
constexpr int A_BOX = TMA_BM * 128;         // 64 rows x 64 channels, 128-byte rows: 8 KB
constexpr int TMA_MAX_SMEM = 232448;        // dynamic shared memory a block may use
constexpr int RED_LD = 72;                  // row stride of the partial sums' exchange (f32)

// Shared memory from the aligned base: the ring of `stages` landed chunks
// (an A box and a 128-row weight box a stage; after the products, the two
// groups' halves of their partial sums), its full and empty mbarriers, the
// rows' LayerNorm statistics [64], row sums [64] and the groups' partial
// row sums [2][64], F1's LayerNorm 1 g and b [TMA_MAX_C] each, and the
// tile's columns of the bias and of the next LayerNorm's g and b [128]
// each. Eight stages (205 KB) hold an SM; four (107 KB) let two blocks
// share one, for launches of more blocks than SMs.
struct TmaSmem {
  static constexpr int STAGE = A_BOX + TMA_BN * 128;
  int stages;
  __host__ __device__ constexpr int bars() const { return stages * STAGE; }
  __host__ __device__ constexpr int stat() const { return bars() + 2 * stages * 8; }
  __host__ __device__ constexpr int par() const { return stat() + 4 * TMA_BM * 8; }
  __host__ __device__ constexpr int bytes() const {
    return par() + (2 * TMA_MAX_C + 3 * TMA_BN) * 4 + wg::SMEM_SLACK;
  }
};
constexpr int TMA_STAGES[2] = {4, 8};
static_assert(2 * TMA_BM * RED_LD * 4 <= 4 * TmaSmem::STAGE, "the exchange fits the ring");

// What a launch reads and writes besides its two tensor maps: STAGE 1 is
// F1 (A = act(LN1 x), x read again for LN1's statistics), 2 F2 (the
// conv's taps), 3 F3 (the residual x)
struct TmaFwdArgs {
  const float* bias;    // [N]
  const float* g;       // F1: LayerNorm 1 [C]
  const float* b;
  const bf16* x;        // F1: the A rows [M, C]; F3: the residual [M, N]
  bf16* out;            // [M, N], or nullptr: not kept
  const float* g_out;   // F1, F2: the next LayerNorm [N]
  const float* b_out;
  bf16* act_out;        // [M, N] = bf16(act(LN(bf16(out))))
  float2* stats_a;      // F1: LN1's (mean, 1/sigma) of x's rows [M], or nullptr
  float2* stats_out;    // F1, F2: the next LayerNorm's of out's rows [M], or nullptr
  int M, L, C, N, taps, dil, gelu;   // M = B * L rows
  int stages;                        // of the ring
};

// A consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(empty);
}

// One launch of K2 on Hopper: the tile of rows m0 + [0, 64) of the B*L rows
// and columns n0 + [0, 128) of out = bf16([res +] A' W^T + bias), A' the
// taps' rows of the A operand (F1: act(LN1 x)). The producer warp's lane 0
// keeps `stages` chunks in flight: a box of the A rows [B*L][C] at row m0 +
// (t - (taps - 1) / 2) dil (rows past either end land as zeros) and the 128
// weight rows of the chunk's channels, landing on the stage's mbarrier.
// The two consumer warpgroups split the chunks (even and odd) and sum them
// in two chains of wgmma m64n128k16, each keeping one chunk's products in
// flight while it issues the next: the chain a block waits on is half the
// reduction, and a launch has twice the blocks of 128-row tiles. Before its
// products a group rewrites its landed A box where it must: F1 normalises
// and activates x in place; F2 zeroes the rows whose tap row lies in
// another chain (the conv's padding, pallas_bytenet.py:174-178). The two
// partial sums meet in shared memory, each group adding the other's half of
// the columns to its own in one order (so both round alike), and each group
// finishes its 64 columns. F1 and F2 launch as a cluster over the row
// tile's column tiles, which exchange the rows' sums through distributed
// shared memory for the next LayerNorm (in rank order, so every block holds
// the same statistics) and write act_out.
template <int STAGE>
__global__ void __launch_bounds__(TMA_THREADS, STAGE == 1 ? 1 : 2)
    wgmma_bytenet_fwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_w, TmaFwdArgs p) {
  constexpr int BN = TMA_BN;
  const TmaSmem SM{p.stages};
  const int S = p.stages;
  unsigned char* smem = wg::aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM.bars());
  uint64_t* empty = full + S;
  float2* sStat = reinterpret_cast<float2*>(smem + SM.stat());
  float2* sRow = sStat + TMA_BM;
  float2* sPart = sRow + TMA_BM;                           // [2][64]: a group's share
  float* sLnG = reinterpret_cast<float*>(smem + SM.par());  // F1: LayerNorm 1
  float* sLnB = sLnG + TMA_MAX_C;
  float* sBias = sLnB + TMA_MAX_C;                         // the tile's columns
  float* sGo = sBias + BN;
  float* sBo = sGo + BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TMA_BM, L = p.L, M = p.M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpt = p.C / 64, n_chunks = p.taps * cpt;
  const int base = STAGE == 1 ? cpt : 0;  // F1's statistics pass comes first in the ring
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      wg::mbar_init(&full[s], 1), wg::mbar_init(&empty[s], TMA_GROUP_WARPS);
    wg::mbar_fence_init();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == TMA_CONSUMERS) {  // the producer: ring position i is stage i % S
    if (lane == 0) {
      wg::tma_prefetch(&map_a);
      wg::tma_prefetch(&map_w);
      for (int i = 0, t = 0, kc = 0; i < base + n_chunks; ++i) {
        const int s = i % S;
        wg::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        unsigned char* st = smem + s * TmaSmem::STAGE;
        if (i < base) {  // F1: x's chunks once for LayerNorm 1's statistics
          wg::mbar_arrive_expect(&full[s], A_BOX);
          wg::tma_load_2d(st, &map_a, &full[s], i * 64, m0);
          continue;
        }
        wg::mbar_arrive_expect(&full[s], TmaSmem::STAGE);
        wg::tma_load_2d(st, &map_a, &full[s], kc * 64, m0 + (t - (p.taps - 1) / 2) * p.dil);
        wg::tma_load_2d(st + A_BOX, &map_w, &full[s], t * p.C + kc * 64, n0);
        if (++kc == cpt) kc = 0, ++t;
      }
    }
    if (STAGE != 3) {  // the cluster's two barriers count every thread
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  const int grp = warp / TMA_GROUP_WARPS, wq = warp % TMA_GROUP_WARPS;
  const int g = lane >> 2, t4 = lane & 3, gt = threadIdx.x % 128;
  // the parameters the epilogue (and F1's transform) read, in shared memory
  for (int c = threadIdx.x; c < BN; c += 32 * TMA_CONSUMERS) {
    sBias[c] = p.bias[n0 + c];
    if (STAGE != 3) sGo[c] = p.g_out[n0 + c], sBo[c] = p.b_out[n0 + c];
  }
  if constexpr (STAGE == 1) {
    for (int c = threadIdx.x; c < p.C; c += 32 * TMA_CONSUMERS) sLnG[c] = p.g[c], sLnB[c] = p.b[c];
    // LayerNorm 1's statistics from x's landed chunks, the groups taking
    // alternate chunks: a thread takes half a row (32 channels a chunk),
    // its neighbour lane the other half
    const int r = gt >> 1, half = gt & 1;
    float s = 0.f, s2 = 0.f;
    for (int i = grp; i < base; i += 2) {
      wg::mbar_wait(&full[i % S], (i / S) & 1);
      const unsigned char* row = smem + (i % S) * TmaSmem::STAGE + r * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Pack<bf16> v;
        v.u = *reinterpret_cast<const uint4*>(row + (((4 * half + q) ^ r) & 7) * 16);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = to_f(v[e]);
          s += f;
          s2 += f * f;
        }
      }
      release(&empty[i % S], lane);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    if (half == 0) sPart[grp * TMA_BM + r] = make_float2(s, s2);
    wg::bar_sync(1, TMA_CONSUMERS * 32);
    if (threadIdx.x < TMA_BM) {
      const int rr = threadIdx.x;
      const float2 a = sPart[rr], b2 = sPart[TMA_BM + rr];
      const bool in = m0 + rr < M;
      sStat[rr] = in ? ln_stats(a.x + b2.x, a.y + b2.y, p.C) : make_float2(0.f, -1.f);
      if (in && p.stats_a && blockIdx.x == 0) p.stats_a[m0 + rr] = sStat[rr];
    }
  }
  wg::bar_sync(1, TMA_CONSUMERS * 32);

  // The thread's four rows of the A box (rows gt / 8 + 16 k, the 16-byte
  // column gt % 8) and their positions in their chains
  int lpos[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lpos[k] = (m0 + gt / 8 + 16 * k) % L;
  const int first = m0 % L;

  float acc[BN / 8][4];
  {
    int prev = -1;
    for (int c = grp; c < n_chunks; c += 2) {
      const int i = base + c, s = i % S, kc = c % cpt, t = c / cpt;
      wg::mbar_wait(&full[s], (i / S) & 1);
      unsigned char* a_rows = smem + s * TmaSmem::STAGE;
      bool rewritten = false;
      if constexpr (STAGE == 1) {  // A' = bf16(act(LN1 x)) in place, zero past the rows
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = gt / 8 + 16 * k, ch = kc * 64 + 8 * ((gt ^ r) & 7);
          const float2 st = sStat[r];
          uint4* cell = reinterpret_cast<uint4*>(a_rows + r * 128 + (gt & 7) * 16);
          Pack<bf16> v;
          v.u = *cell;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = from_f<bf16>(st.y >= 0.f ? act_fn(ln_affine(to_f(v[e]), st, sLnG[ch + e],
                                                               sLnB[ch + e]), p.gelu)
                                            : 0.f);
          *cell = v.u;
        }
        rewritten = true;
      } else {
        // F2: the rows whose tap row lies in another chain become zeros;
        // only where the tile has such rows
        const int shift = (t - (p.taps - 1) / 2) * p.dil;
        if (shift != 0 && (first + TMA_BM - 1 >= L || (shift > 0 ? first + TMA_BM - 1 >= L - shift
                                                                  : first < -shift))) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (lpos[k] + shift < 0 || lpos[k] + shift >= L)
              *reinterpret_cast<uint4*>(a_rows + (gt / 8 + 16 * k) * 128 + (gt & 7) * 16) =
                  make_uint4(0, 0, 0, 0);
          rewritten = true;
        }
      }
      if (rewritten) {  // written by threads, read by wgmma
        wg::fence_proxy();
        wg::bar_sync(2 + grp, 128);
      }
      const uint64_t da = wg::desc(a_rows, 0, 1024);
      const uint64_t db = wg::desc(a_rows + A_BOX, 0, 1024);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n128<0>(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 32 * kk),
                           c > grp || kk > 0);
      wg::commit();
      wg::wait<1>();  // the group's previous chunk is done
      if (prev >= 0) release(&empty[prev], lane);
      prev = s;
    }
    wg::wait<0>();
    if (prev >= 0) release(&empty[prev], lane);
    if (grp >= n_chunks) {  // a group with no chunk adds nothing (one-chunk reductions)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
  }
  wg::fence_acc(acc);

  // the two partial sums: each group hands the other its half of the
  // columns through the ring (every product is done) and adds the other's
  wg::bar_sync(1, TMA_CONSUMERS * 32);
  float* red = reinterpret_cast<float*>(smem);
  const int other = 8 * (1 - grp);  // the n-tiles of the other group's half
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(red + (grp * TMA_BM + 16 * wq + g + 8 * hh) * RED_LD + 8 * j +
                                 2 * t4) =
          make_float2(acc[other + j][2 * hh], acc[other + j][2 * hh + 1]);
  wg::bar_sync(1, TMA_CONSUMERS * 32);
  float v[8][4];  // this group's 64 columns, n-tiles 8 grp + j
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 o = *reinterpret_cast<const float2*>(
          red + ((1 - grp) * TMA_BM + 16 * wq + g + 8 * hh) * RED_LD + 8 * j + 2 * t4);
      const float a0 = acc[8 * grp + j][2 * hh], a1 = acc[8 * grp + j][2 * hh + 1];
      v[j][2 * hh] = grp == 0 ? a0 + o.x : o.x + a0;
      v[j][2 * hh + 1] = grp == 0 ? a1 + o.y : o.y + a1;
    }

  // epilogue on the group's columns cb + [0, 64): bias, residual, rounding
  // (kept in v); the rounded values' row sums
  const int cb = 64 * grp, rw = 16 * wq;
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if constexpr (STAGE == 3) {  // the residual's loads first, all in flight together
    float2 res[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t m = (size_t)m0 + rw + g + 8 * hh;
        res[j][hh] = m < (size_t)M ? load2(p.x + m * p.N + n0 + cb + 8 * j + 2 * t4)
                                   : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        v[j][2 * hh] = res[j][hh].x + (v[j][2 * hh] + sBias[cb + 8 * j + 2 * t4]);
        v[j][2 * hh + 1] = res[j][hh].y + (v[j][2 * hh + 1] + sBias[cb + 8 * j + 2 * t4 + 1]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] += sBias[cb + 8 * j + 2 * t4 + (e & 1)];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + cb + 8 * j + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t m = (size_t)m0 + rw + g + 8 * hh;
      const float v0 = to_f(from_f<bf16>(v[j][2 * hh]));
      const float v1 = to_f(from_f<bf16>(v[j][2 * hh + 1]));
      v[j][2 * hh] = v0;
      v[j][2 * hh + 1] = v1;
      if (m >= (size_t)M) continue;
      if (p.out) store2(p.out + m * p.N + col, v0, v1);
      rs[hh][0] += v0 + v1;
      rs[hh][1] += v0 * v0 + v1 * v1;
    }
  }
  if constexpr (STAGE != 3) {
    // the full rows' statistics: the four lanes of a row, the two groups in
    // order, then every block of the cluster in rank order
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs[hh][k] += __shfl_xor_sync(0xffffffffu, rs[hh][k], 1);
        rs[hh][k] += __shfl_xor_sync(0xffffffffu, rs[hh][k], 2);
      }
      if (t4 == 0) sPart[grp * TMA_BM + rw + g + 8 * hh] = make_float2(rs[hh][0], rs[hh][1]);
    }
    wg::bar_sync(1, TMA_CONSUMERS * 32);
    if (threadIdx.x < TMA_BM) {
      const float2 a = sPart[threadIdx.x], b2 = sPart[TMA_BM + threadIdx.x];
      sRow[threadIdx.x] = make_float2(a.x + b2.x, a.y + b2.y);
    }
    cluster.sync();  // every block's sRow is written
    if (threadIdx.x < TMA_BM) {
      const int r = threadIdx.x;
      float s = 0.f, s2 = 0.f;
      for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
        const float2 w = *cluster.map_shared_rank(sRow + r, k);
        s += w.x;
        s2 += w.y;
      }
      sStat[r] = ln_stats(s, s2, p.N);
      if (p.stats_out && blockIdx.x == 0 && m0 + r < M) p.stats_out[m0 + r] = sStat[r];
    }
    cluster.sync();  // every block has read the others' sRow; sStat is written
    // act_out = bf16(act(LN(out))) from the rounded values in v
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb + 8 * j + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rw + g + 8 * hh;
        if (m0 + r >= M) continue;
        const float2 st = sStat[r];
        store2(p.act_out + ((size_t)m0 + r) * p.N + n0 + c,
               act_fn(ln_affine(v[j][2 * hh], st, sGo[c], sBo[c]), p.gelu),
               act_fn(ln_affine(v[j][2 * hh + 1], st, sGo[c + 1], sBo[c + 1]), p.gelu));
      }
    }
  }
}

const void* const TMA_KERNELS[3] = {(const void*)wgmma_bytenet_fwd_gemm_kernel<1>,
                                    (const void*)wgmma_bytenet_fwd_gemm_kernel<2>,
                                    (const void*)wgmma_bytenet_fwd_gemm_kernel<3>};

// Each Hopper kernel's limit on dynamic shared memory, set once for all three
// (the first call of a process is eager: a graph capture sets nothing)
cudaError_t tma_limits() {
  static const cudaError_t err = [] {
    for (const void* k : TMA_KERNELS) {
      const cudaError_t e =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TmaSmem{TMA_STAGES[1]}.bytes());
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

// The plan of one launch as the caller computed it
// (ops/fused_bytenet.py::bytenet_block_plan), 18 values: grid x, y, z,
// cluster x, threads, shared-memory bytes, BN, the ring's stages, the A
// rows' map (dims, innermost first, byte stride, box) and the weight map's
// (the same)
constexpr int PLAN_LEN = 18;

// Refuse a plan other than this source's own for the launch, then launch it
cudaError_t launch_tma(int stage, const long long* plan, const void* a_rows, const void* w,
                       TmaFwdArgs args, cudaStream_t stream) {
  const long long C = args.C, N = args.N, M = args.M, taps = args.taps;
  if (N % TMA_BN || C % 64 || C > TMA_MAX_C || reinterpret_cast<uintptr_t>(a_rows) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  const long long stages = plan[7];
  if (stages != TMA_STAGES[0] && stages != TMA_STAGES[1]) return cudaErrorInvalidValue;
  args.stages = (int)stages;
  const long long tiles_n = N / TMA_BN, smem = TmaSmem{(int)stages}.bytes();
  const long long want[PLAN_LEN] = {tiles_n, (M + TMA_BM - 1) / TMA_BM, 1,
                                    stage == 3 ? 1 : tiles_n, TMA_THREADS, smem, TMA_BN,
                                    stages, C, M, C * 2, 64, TMA_BM,
                                    taps * C, N, taps * C * 2, 64, TMA_BN};
  for (int i = 0; i < PLAN_LEN; ++i)
    if (plan[i] != want[i]) return cudaErrorInvalidValue;
  if (want[3] > MAX_CLUSTER || smem > TMA_MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  const cuuint64_t a_dims[2] = {(cuuint64_t)plan[8], (cuuint64_t)plan[9]};
  const cuuint64_t a_strides[1] = {(cuuint64_t)plan[10]};
  const cuuint32_t a_box[2] = {(cuuint32_t)plan[11], (cuuint32_t)plan[12]};
  const cuuint64_t w_dims[2] = {(cuuint64_t)plan[13], (cuuint64_t)plan[14]};
  const cuuint64_t w_strides[1] = {(cuuint64_t)plan[15]};
  const cuuint32_t w_box[2] = {(cuuint32_t)plan[16], (cuuint32_t)plan[17]};
  if (!wg::encode(&ma, a_rows, 2, a_dims, a_strides, a_box) ||
      !wg::encode(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan[0], (unsigned)plan[1], (unsigned)plan[2]);
  cfg.blockDim = dim3((unsigned)plan[4]);
  cfg.dynamicSmemBytes = (size_t)plan[5];
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)plan[3];
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  void* params[3] = {&ma, &mw, &args};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, TMA_KERNELS[stage - 1], params);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x, y [B, L, D]; w1 [H, D]; wc [H, K, H] ([out][tap][in]); w2 [D, H] (all in
// the activation type); g*/b*/c* f32; p, q [B, L, H] out (the pre-LayerNorm
// Dense and conv outputs, kept for the backward; either may be null: not
// kept); bb, e [B, L, H] scratch in the activation type; stats [3][B*L] f32
// (mean, 1/sigma) pairs out, the LayerNorm statistics of x, p and q rows
// (the backward's residuals), or null. D and H multiples of
// 32, H at most 1024 (a cluster spans H's column tiles), K odd. dtype 0 =
// float32, 1 = bfloat16; act 0 = ReLU, 1 = GELU. Sets *launched to the
// number of kernels launched (3 on success) and returns a cudaError_t code
// (0 = all launched).
extern "C" int hd_bytenet_block_fwd(const void* x, const void* g1, const void* b1,
                                    const void* w1, const void* c1, const void* g2,
                                    const void* b2, const void* wc, const void* cc,
                                    const void* g3, const void* b3, const void* w2,
                                    const void* c2, void* p, void* q, void* y, void* bb, void* e,
                                    void* stats, int B, int L, int D, int H, int K, int dil, int act,
                                    int dtype, void* stream, int* launched) {
  *launched = 0;
  // a cluster spans the column tiles of H: at most MAX_CLUSTER of 128
  if (B <= 0 || L <= 0 || D <= 0 || H <= 0 || D % 32 || H % 32 || H > 128 * MAX_CLUSTER ||
      K <= 0 || K % 2 == 0 || dil <= 0 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  const float* prm[9] = {f(g1), f(b1), f(c1), f(g2), f(b2), f(cc), f(g3), f(b3), f(c2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float2*>(stats);
  if (dtype == 0) {
    auto o = [](void* v) { return static_cast<float*>(v); };
    return launch<float>(f(x), prm, f(w1), f(wc), f(w2), o(p), o(q), o(y), o(bb), o(e), st, B, L,
                         D, H, K, dil, act, s, launched);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    auto h = [](const void* v) { return static_cast<const bf16*>(v); };
    auto o = [](void* v) { return static_cast<bf16*>(v); };
    return launch<bf16>(h(x), prm, h(w1), h(wc), h(w2), o(p), o(q), o(y), o(bb), o(e), st, B, L,
                        D, H, K, dil, act, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}

// K2 on Hopper: bf16, D and H multiples of 128 (the shapes
// ops/fused_bytenet.py::bytenet_block_plan gives this path). Arguments as
// hd_bytenet_block_fwd's, without dtype; x, w1, wc, w2 and the scratch bb, e
// at 16-byte aligned addresses (TMA); `plan` the three launches' plans
// (3 x PLAN_LEN values, F1, F2, F3), each refused unless it is this
// source's own. Sets *launched to the kernels launched (3 on success) and
// returns a cudaError_t code (0 = all launched).
extern "C" int hd_bytenet_block_fwd_tma(const void* x, const void* g1, const void* b1,
                                        const void* w1, const void* c1, const void* g2,
                                        const void* b2, const void* wc, const void* cc,
                                        const void* g3, const void* b3, const void* w2,
                                        const void* c2, void* p, void* q, void* y, void* bb,
                                        void* e, void* stats, int B, int L, int D, int H, int K,
                                        int dil, int act, const long long* plan, void* stream,
                                        int* launched) {
  *launched = 0;
  if (B <= 0 || L <= 0 || D <= 0 || H <= 0 || D % TMA_BN || H % TMA_BN || K <= 0 || K % 2 == 0 ||
      dil <= 0 || (act != 0 && act != 1) || (long long)B * L > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tma_limits();
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto h = [](const void* v) { return static_cast<const bf16*>(v); };
  auto o = [](void* v) { return static_cast<bf16*>(v); };
  const size_t M = (size_t)B * L;
  float2* st = static_cast<float2*>(stats);
  float2* st2 = st ? st + M : nullptr;
  float2* st3 = st ? st + 2 * M : nullptr;
  const int rows = B * L;
  const TmaFwdArgs f1{f(c1), f(g1), f(b1), h(x), o(p), f(g2), f(b2), o(bb), st, st2,
                      rows, L, D, H, 1, 0, act};
  const TmaFwdArgs f2{f(cc), nullptr, nullptr, nullptr, o(q), f(g3), f(b3), o(e), nullptr, st3,
                      rows, L, H, H, K, dil, act};
  const TmaFwdArgs f3{f(c2), nullptr, nullptr, h(x), o(y), nullptr, nullptr, nullptr, nullptr,
                      nullptr, rows, L, H, D, 1, 0, act};
  auto s = static_cast<cudaStream_t>(stream);
  const void* operand[3] = {x, bb, e};
  const void* weights[3] = {w1, wc, w2};
  const TmaFwdArgs* args[3] = {&f1, &f2, &f3};
  for (int i = 0; i < 3; ++i) {  // *launched counts the kernels launched, in order
    if ((err = launch_tma(i + 1, plan + i * PLAN_LEN, operand[i], weights[i], *args[i], s)) !=
        cudaSuccess)
      return (int)err;
    ++*launched;
  }
  return 0;
}
