// K2: the ByteNet residual block forward, as three launches, one GEMM each,
// with every LayerNorm + activation folded into a GEMM, in three designs.
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
// against about 30 MB of activations (9 us at 3.35 TB/s). What holds the
// designs far from that: at the training batches, the bytes each chunk of
// products reads from L2 (a 64 x 128 tile reads 24 KB a 1 MFLOP chunk) and,
// for GELU, F1's LayerNorm + activation of x, which every column tile
// repeats (most of F1's time at 512/256); at the sampler's B <= 16 (2,432
// rows or fewer), each block's chain of dependent chunks (42 for the conv
// at H = 384), its epilogue and the three dependent launches.
//
// Which design takes which shape (ops/fused_bytenet.py::bytenet_block_plan,
// from tools/bytenet_fwd_sweep.py on an H100; the entries refuse any other
// plan): bf16 with D and H multiples of 128 takes the 64-row Hopper design
// up to 4,096 rows (B <= 16 at L = 152: the sampler, a lone request; the
// 256/128 tower up to 8,192 rows, B = 32) and the 128-row one past them
// (the fine-tuning, the bench's sampler and the pretraining batches). The
// cp.async + mma.sync design keeps the demos' widths, and its FMA path f32.
//
// Hopper designs (wgmma_tiles.cuh; bytenet_tiles.cuh the parts K4 shares),
// the same three GEMMs and rounding points. A producer warp keeps a ring of
// stages full by TMA, each an A box of the tile's rows and 64 channels
// (128-byte swizzle: rows past the ends are TMA's zeros; the F2 tap t box
// starts (t - (K - 1) / 2) dil rows on) and the tile's weight rows of the
// same channels (K-major B operands as they lie, [N][taps * C]). Where a
// landed box must change, the groups that read it rewrite it in place (then
// a proxy fence and a group barrier): F1's x becomes bf16(act(LN1 x)),
// LN1's statistics summed first (both designs sum x's rows in one order:
// the same statistics), from global memory while the ring fills in the
// 64-row design, through the ring ahead of the chunks in the 128-row one;
// F2
// zeroes the rows whose tap row lies in another chain (the conv's padding;
// pallas_bytenet.py:174-178), only in tiles that have such rows. F1 and F2
// launch as clusters over a row tile's column tiles, which take the next
// LayerNorm's row sums through distributed shared memory, in rank order.
// F2 and F3 are programmatic dependent launches: each starts under the
// previous launch's tail, sets up and asks for its first weights, and waits
// for that launch before it reads or writes anything else.
//  - 64-row design (wgmma_bytenet_fwd_gemm_kernel<STAGE, BN>): 64 x BN tiles
//    (BN 128, or 64 where a launch has few tiles), a ring of 8 stages (one
//    block an SM) or 4 (two); two consumer warpgroups split the chunks, even
//    and odd, each a chain of wgmma m64nBNk16 with the next chunk issued
//    before the last is waited on: the chain a block waits on is half the
//    reduction. The partial sums meet in shared memory, each group adding
//    the other's half of the columns to its own in one order, so both round
//    alike; each group finishes its columns from registers (bias, residual,
//    rounding; the residual's loads issued together).
//  - 128-row design (wgmma_wide_bytenet_fwd_gemm_kernel<STAGE, BN>, K4's
//    data-GEMM block): 128 x 128 tiles, two consumer warpgroups of 64 rows
//    over every chunk, three 32 KB stages, two blocks an SM; F1 takes 128 x
//    256 tiles where N allows, four warpgroups and one block an SM, so that
//    x is rewritten once a row tile. The epilogue runs over the products
//    staged in shared memory, a warp a row.
//
// The cp.async + mma.sync design (gemm_tiles.cuh's pipelined core; one
// kernel, bytenet_fwd_gemm_kernel):
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
namespace bt = hd::bt;

constexpr int TMA_BM = 64;                  // rows of a tile of the 64-row design
constexpr int TMA_BN = 128;                 // columns of a tile (the 64-row design: or 64)
constexpr int WIDE_BM = 128;                // rows of a tile of the 128-row design
constexpr int TMA_GROUP_WARPS = 4;          // a consumer warpgroup; two a block
constexpr int TMA_CONSUMERS = 2 * TMA_GROUP_WARPS;
constexpr int TMA_THREADS = (TMA_CONSUMERS + 1) * 32;  // and one producer warp
constexpr int TMA_MAX_C = 1024;             // F1: LayerNorm 1's g and b held in shared memory
constexpr int A_BOX = TMA_BM * 128;         // 64 rows x 64 channels, 128-byte rows: 8 KB
constexpr int TMA_MAX_SMEM = 232448;        // dynamic shared memory a block may use
constexpr int RED_LD = 72;                  // row stride of the partial sums' exchange (f32)

// The 64-row design's shared memory from the aligned base: the ring of
// `stages` landed chunks (an A box and a `bn`-row weight box a stage; after
// the products, the two groups' halves of their partial sums), its full
// and empty mbarriers, the rows' LayerNorm statistics [64], row sums [64]
// and the groups' partial row sums [2][64], F1's LayerNorm 1 g and b
// [TMA_MAX_C] each, and the tile's columns of the bias and of the next
// LayerNorm's g and b [bn] each. Eight stages hold an SM; four let two
// blocks share one, for launches of more blocks than SMs.
struct TmaSmem {
  int stages, bn;
  __host__ __device__ constexpr int stage() const { return A_BOX + bn * 128; }
  __host__ __device__ constexpr int bars() const { return stages * stage(); }
  __host__ __device__ constexpr int stat() const { return bars() + 2 * stages * 8; }
  __host__ __device__ constexpr int par() const { return stat() + 4 * TMA_BM * 8; }
  __host__ __device__ constexpr int bytes() const {
    return par() + (2 * TMA_MAX_C + 3 * bn) * 4 + wg::SMEM_SLACK;
  }
};
constexpr int TMA_STAGES[2] = {4, 8};
static_assert(2 * TMA_BM * RED_LD * 4 <= 4 * TmaSmem{4, 64}.stage(), "the exchange fits the ring");

// The 128-row design's: the ring (a stage: the A rows [128][64] as one box,
// a warpgroup's 64 rows 8 KB apart, and the bn weight rows of the chunk's
// channels: 32 or 48 KB), the mbarriers, the rows' statistics and row sums
// [128] each, F1's LayerNorm 1 g and b [TMA_MAX_C], the tile's bias and
// next g, b [bn]. After the products the first stages hold them in f32
// (bt::DTile). With 128 columns three stages let two blocks share an SM
// and six hold one; with 256, four hold one.
struct WideSmem {
  static constexpr int A = WIDE_BM * 128;
  int stages, bn;
  __host__ __device__ constexpr int stage() const { return A + bn * 128; }
  __host__ __device__ constexpr int bars() const { return stages * stage(); }
  __host__ __device__ constexpr int stat() const { return bars() + 256; }
  __host__ __device__ constexpr int par() const { return stat() + 2 * WIDE_BM * 8; }
  __host__ __device__ constexpr int bytes() const {
    return par() + (2 * TMA_MAX_C + 3 * bn) * 4 + wg::SMEM_SLACK;
  }
};
constexpr int WIDE_STAGES[2] = {3, 6};  // 128 columns
constexpr int WIDE_STAGES_256 = 4;      // 256 columns
static_assert(WIDE_BM * 128 * 4 <= 2 * WideSmem{3, 128}.stage() &&
                  WIDE_BM * 256 * 4 <= 3 * WideSmem{4, 256}.stage() && 2 * 6 * 8 <= 256,
              "the products fit the first stages; the mbarriers their room");

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

// The producer warp's lane 0: ring position i is stage i % S, a stage
// `stage` bytes: an A box of `a_bytes` at its start, the weights' box after
// it. The first `base` positions are x's chunks alone (the 128-row F1's
// pass for LayerNorm 1's statistics); then every chunk of the reduction:
// the A rows at row m0 + (t - (taps - 1) / 2) dil (rows past either end
// land as zeros) and the weights' rows n0 + [0, bn) of the chunk's
// channels. F2 and F3 may start under the launch before them (programmatic
// dependent launch); F1 starts once the launch before it has ended, as the
// plan launches it. A launch reads and writes nothing before grid_wait but
// the weights, which were written before F1 began (F2 can start only once
// every block of F1 has passed its grid_wait): the producer asks for the
// weights of the first stages before grid_wait, so that under F2 and F3
// they land under the previous launch's tail.
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* map_a, const CUtensorMap* map_w,
                                        const TmaFwdArgs& p, int S, int stage, int a_bytes,
                                        int base, int m0, int n0) {
  const int cpt = p.C / 64, n_chunks = p.taps * cpt, mid = (p.taps - 1) / 2;
  wg::tma_prefetch(map_a);
  wg::tma_prefetch(map_w);
  const int early = base ? 0 : min(S, n_chunks);
  for (int i = 0; i < early; ++i) {
    wg::mbar_arrive_expect(&full[i], stage);
    wg::tma_load_2d(smem + i * stage + a_bytes, map_w, &full[i], (i / cpt) * p.C + (i % cpt) * 64,
                    n0);
  }
  wg::grid_wait();
  for (int i = 0, t = 0, kc = 0; i < base + n_chunks; ++i) {
    const int s = i % S;
    unsigned char* st = smem + s * stage;
    if (i >= early) wg::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
    if (i < base) {  // x's chunks once for LayerNorm 1's statistics
      wg::mbar_arrive_expect(&full[s], a_bytes);
      wg::tma_load_2d(st, map_a, &full[s], i * 64, m0);
      continue;
    }
    if (i >= early) {
      wg::mbar_arrive_expect(&full[s], stage);
      wg::tma_load_2d(st + a_bytes, map_w, &full[s], t * p.C + kc * 64, n0);
    }
    wg::tma_load_2d(st, map_a, &full[s], kc * 64, m0 + (t - mid) * p.dil);
    if (++kc == cpt) kc = 0, ++t;
  }
}

// F1's A' = bf16(act(LN1 x)) in place on a landed 64-row box of chunk kc,
// zero past the rows (sStat[r].y < 0): the warpgroup's thread gt takes rows
// gt / 8 + 16 k, k = k0, k0 + KS, ... < 4, and the 16-byte column gt % 8
template <int KS = 1>
__device__ __forceinline__ void ln_act_box(unsigned char* box, const float2* sStat,
                                           const float* g, const float* b, int kc, int gt,
                                           int gelu, int k0 = 0) {
#pragma unroll
  for (int j = 0; j < 4 / KS; ++j) {
    const int r = gt / 8 + 16 * (k0 + KS * j), ch = kc * 64 + 8 * ((gt ^ r) & 7);
    const float2 st = sStat[r];
    uint4* cell = reinterpret_cast<uint4*>(box + r * 128 + (gt & 7) * 16);
    uint4 u = *cell;
    const float4 gv[2] = {*reinterpret_cast<const float4*>(g + ch),
                          *reinterpret_cast<const float4*>(g + ch + 4)};
    const float4 bv[2] = {*reinterpret_cast<const float4*>(b + ch),
                          *reinterpret_cast<const float4*>(b + ch + 4)};
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
      const float4& gq = gv[q / 2];
      const float4& bq = bv[q / 2];
      const float g0 = q % 2 ? gq.z : gq.x, g1 = q % 2 ? gq.w : gq.y;
      const float b0 = q % 2 ? bq.z : bq.x, b1 = q % 2 ? bq.w : bq.y;
      w[q] = st.y >= 0.f ? tc::pack(act_fn(ln_affine(f.x, st, g0, b0), gelu),
                                    act_fn(ln_affine(f.y, st, g1, b1), gelu))
                         : 0u;
    }
    *cell = u;
  }
}

// LayerNorm 1's sums over 32 channels of a row of x (half a 64-channel
// chunk: the thread's neighbour lane takes the other half), added to s, s2
// in channel order, the order both Hopper designs keep: x_sums from global
// memory (the 64-row design, while its ring fills), box_sums from a landed
// 64-row box of the 128-row design's statistics pass through its ring.
// Each read faster for its design on an H100 (at B = 16 and at B = 128).
__device__ __forceinline__ void add_sums(Pack<bf16> (&v)[4], float& s, float& s2) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = to_f(v[q][e]);
      s += f;
      s2 += f * f;
    }
}
__device__ __forceinline__ void x_sums(const bf16* x, float& s, float& s2) {
  Pack<bf16> v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q].u = *reinterpret_cast<const uint4*>(x + 8 * q);
  add_sums(v, s, s2);
}
__device__ __forceinline__ void box_sums(const unsigned char* box, int gt, float& s, float& s2) {
  const int r = gt >> 1, half = gt & 1;
  Pack<bf16> v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q].u = *reinterpret_cast<const uint4*>(box + r * 128 + (((4 * half + q) ^ r) & 7) * 16);
  add_sums(v, s, s2);
}

// m64nBNk16 with B K-major ([BN n][k] rows, as the weights lie)
template <int BN>
__device__ __forceinline__ void mma_k(float (&d)[BN / 8][4], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128)
    wg::mma_m64n128<0>(d, da, db, acc);
  else
    wg::mma_m64n64<0>(d, da, db, acc);
}

// One launch of K2 on Hopper, 64-row design: the tile of rows m0 + [0, 64)
// of the B*L rows and columns n0 + [0, BN) of out = bf16([res +] A' W^T +
// bias), A' the taps' rows of the A operand (F1: act(LN1 x)). The producer
// warp keeps `stages` chunks in flight (produce). The two consumer
// warpgroups split the chunks (even and odd) and sum them in two chains
// of wgmma m64nBNk16, each keeping one chunk's products in flight while
// it issues the next: the chain a block waits on is half the reduction,
// and a launch has twice the blocks of 128-row tiles. Before its products
// a group rewrites its landed A box where it must: F1 normalises and
// activates x in place; F2 zeroes the rows whose tap row lies in another
// chain (the conv's padding, pallas_bytenet.py:174-178). The two partial
// sums meet in shared memory, each group adding the other's half of the
// columns to its own in one order (so both round alike), and each group
// finishes its BN / 2 columns. F1 and F2 launch as a cluster over the row
// tile's column tiles, which exchange the rows' sums through distributed
// shared memory for the next LayerNorm (in rank order, so every block holds
// the same statistics) and write act_out.
template <int STAGE, int BN>
__global__ void __launch_bounds__(TMA_THREADS, STAGE == 1 ? 1 : 2)
    wgmma_bytenet_fwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_w, TmaFwdArgs p) {
  constexpr int HN = BN / 16;  // n-tiles of 8 columns in a group's half of the columns
  const TmaSmem SM{p.stages, BN};
  const int S = p.stages, STG = SM.stage();
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
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      wg::mbar_init(&full[s], 1), wg::mbar_init(&empty[s], TMA_GROUP_WARPS);
    wg::mbar_fence_init();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == TMA_CONSUMERS) {
    if (lane == 0) produce(smem, full, empty, &map_a, &map_w, p, S, STG, A_BOX, 0, m0, n0);
    wg::grid_wait();
    wg::grid_launch();
    if (STAGE != 3) {  // the cluster's two barriers count every thread
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  const int grp = warp / TMA_GROUP_WARPS, wq = warp % TMA_GROUP_WARPS;
  const int g = lane >> 2, t4 = lane & 3, gt = threadIdx.x % 128;
  wg::grid_wait();  // nothing is read or written before the launch before this one has ended
  wg::grid_launch();
  // the parameters the epilogue (and F1's transform) read, in shared memory
  for (int c = threadIdx.x; c < BN; c += 32 * TMA_CONSUMERS) {
    sBias[c] = p.bias[n0 + c];
    if (STAGE != 3) sGo[c] = p.g_out[n0 + c], sBo[c] = p.b_out[n0 + c];
  }
  if constexpr (STAGE == 1)
    for (int c = threadIdx.x; c < p.C; c += 32 * TMA_CONSUMERS) sLnG[c] = p.g[c], sLnB[c] = p.b[c];
  if constexpr (STAGE == 1) {
    // LayerNorm 1's statistics of the tile's rows from x, while the ring
    // fills: the groups take alternate chunks, a thread half of each
    const int r = gt >> 1, half = gt & 1;
    float s = 0.f, s2 = 0.f;
    if (m0 + r < M) {
      const bf16* row = p.x + (size_t)(m0 + r) * p.C + 32 * half;
#pragma unroll 2
      for (int i = grp; i < cpt; i += 2) x_sums(row + 64 * i, s, s2);
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
      const int s = c % S, kc = c % cpt, t = c / cpt;
      wg::mbar_wait(&full[s], (c / S) & 1);
      unsigned char* a_rows = smem + s * STG;
      bool rewritten = false;
      if constexpr (STAGE == 1) {
        ln_act_box(a_rows, sStat, sLnG, sLnB, kc, gt, p.gelu);
        rewritten = true;
      } else {
        // F2: the rows whose tap row lies in another chain become zeros;
        // only where the tile has such rows
        const int shift = (t - (p.taps - 1) / 2) * p.dil;
        if (bt::crosses(first, shift, L)) {
          bt::zero_rows(a_rows, lpos, shift, L, gt);
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
        mma_k<BN>(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 32 * kk), c > grp || kk > 0);
      wg::commit();
      wg::wait<1>();  // the group's previous chunk is done
      if (prev >= 0) bt::release(&empty[prev], lane);
      prev = s;
    }
    wg::wait<0>();
    if (prev >= 0) bt::release(&empty[prev], lane);
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
  const int other = HN * (1 - grp);  // the n-tiles of the other group's half
#pragma unroll
  for (int j = 0; j < HN; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(red + (grp * TMA_BM + 16 * wq + g + 8 * hh) * RED_LD + 8 * j +
                                 2 * t4) =
          make_float2(acc[other + j][2 * hh], acc[other + j][2 * hh + 1]);
  wg::bar_sync(1, TMA_CONSUMERS * 32);
  float v[HN][4];  // this group's BN / 2 columns, n-tiles HN grp + j
#pragma unroll
  for (int j = 0; j < HN; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 o = *reinterpret_cast<const float2*>(
          red + ((1 - grp) * TMA_BM + 16 * wq + g + 8 * hh) * RED_LD + 8 * j + 2 * t4);
      const float a0 = acc[HN * grp + j][2 * hh], a1 = acc[HN * grp + j][2 * hh + 1];
      v[j][2 * hh] = grp == 0 ? a0 + o.x : o.x + a0;
      v[j][2 * hh + 1] = grp == 0 ? a1 + o.y : o.y + a1;
    }

  // epilogue on the group's columns cb + [0, BN / 2): bias, residual,
  // rounding (kept in v); the rounded values' row sums
  const int cb = (BN / 2) * grp, rw = 16 * wq;
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if constexpr (STAGE == 3) {  // the residual's loads first, all in flight together
    float2 res[HN][2];
#pragma unroll
    for (int j = 0; j < HN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t m = (size_t)m0 + rw + g + 8 * hh;
        res[j][hh] = m < (size_t)M ? load2(p.x + m * p.N + n0 + cb + 8 * j + 2 * t4)
                                   : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < HN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        v[j][2 * hh] = res[j][hh].x + (v[j][2 * hh] + sBias[cb + 8 * j + 2 * t4]);
        v[j][2 * hh + 1] = res[j][hh].y + (v[j][2 * hh + 1] + sBias[cb + 8 * j + 2 * t4 + 1]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < HN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] += sBias[cb + 8 * j + 2 * t4 + (e & 1)];
  }
#pragma unroll
  for (int j = 0; j < HN; ++j) {
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
    const float2 tot = bt::cluster_row_sums<TMA_BM>(sRow, cluster);
    if (threadIdx.x < TMA_BM) {
      const int r = threadIdx.x;
      sStat[r] = ln_stats(tot.x, tot.y, p.N);
      if (p.stats_out && blockIdx.x == 0 && m0 + r < M) p.stats_out[m0 + r] = sStat[r];
    }
    wg::bar_sync(1, TMA_CONSUMERS * 32);
    // act_out = bf16(act(LN(out))) from the rounded values in v
#pragma unroll
    for (int j = 0; j < HN; ++j) {
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

// One launch of K2 on Hopper, 128-row design (the training batches, where
// 64-row tiles are L2-bound: a 24 KB stage a 1 MFLOP chunk): the tile of
// rows m0 + [0, 128) and columns n0 + [0, BN), K4's data-GEMM block. The
// producer warp keeps `stages` chunks in flight (produce: the A rows as one
// 128-row box). BN / 64 consumer warpgroups each take 64 of the rows and
// 128 of the columns over every chunk, a chain of wgmma m64n128k16 with one
// chunk in flight while the next is issued, and rewrite their half of the
// A box where it must, as the 64-row design does (F1: act(LN1 x), the
// groups of a row half splitting its cells, LayerNorm 1's statistics taken
// first from a pass of x's chunks through the ring, a group's rows each,
// even and odd chunks summed apart and then added as the 64-row design's
// two groups add them,
// so both designs hold the same statistics of x; F2: the conv's rows from
// another chain zeroed). With 128 columns two blocks share an SM, so that
// one's epilogue runs under the other's products; 256 columns (four
// groups, one block an SM) halve a launch's column tiles where N allows:
// F1 rewrites x once a row tile, not once a column tile (its LayerNorm and
// GELU are most of F1's time), and a 4 MFLOP chunk reads 48 KB, not 64.
// The epilogue runs over the products put in shared memory, a warp a row,
// four columns of each 128 a lane, in small loops (an epilogue unrolled
// per accumulator register ran from instruction-cache misses in K4): bias,
// residual (its loads issued together first), rounding, out written, the
// rows' sums; F1 and F2 launch as a cluster over the row tile's column
// tiles, which exchange the sums through distributed shared memory in rank
// order; then act_out.
template <int BN> constexpr int wide_threads() { return (BN / 64 * TMA_GROUP_WARPS + 1) * 32; }

template <int STAGE, int BN>
__global__ void __launch_bounds__(wide_threads<BN>(), BN == TMA_BN ? 2 : 1)
    wgmma_wide_bytenet_fwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                       const __grid_constant__ CUtensorMap map_w, TmaFwdArgs p) {
  constexpr int BM = WIDE_BM, NH = BN / 128;   // n128 column halves
  constexpr int GROUPS = 2 * NH, CW = GROUPS * TMA_GROUP_WARPS;  // consumer groups, warps
  constexpr int WR = BM / CW;                  // rows of a warp in the epilogue: warp + CW i
  const WideSmem SM{p.stages, BN};
  const int S = p.stages, STG = SM.stage();
  unsigned char* smem = wg::aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM.bars());
  uint64_t* empty = full + S;
  float2* sStat = reinterpret_cast<float2*>(smem + SM.stat());
  float2* sRow = sStat + BM;
  float* sLnG = reinterpret_cast<float*>(smem + SM.par());  // F1: LayerNorm 1
  float* sLnB = sLnG + TMA_MAX_C;
  float* sBias = sLnB + TMA_MAX_C;                         // the tile's columns
  float* sGo = sBias + BN;
  float* sBo = sGo + BN;
  const bt::DTile<BN> sD{reinterpret_cast<float*>(smem)};  // the products, over the ring
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, L = p.L, M = p.M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpt = p.C / 64, n_chunks = p.taps * cpt;
  const int base = STAGE == 1 ? cpt : 0;  // F1's statistics pass comes first in the ring
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) wg::mbar_init(&full[s], 1), wg::mbar_init(&empty[s], CW);
    wg::mbar_fence_init();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == CW) {
    if (lane == 0) produce(smem, full, empty, &map_a, &map_w, p, S, STG, WideSmem::A, base, m0, n0);
    wg::grid_wait();
    wg::grid_launch();
    if (STAGE != 3) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // group grp: rows 64 rh + [0, 64) and columns 128 ch + [0, 128) of the tile;
  // the groups of a row half (NH of them) meet at barrier 2 + rh
  const int grp = warp / TMA_GROUP_WARPS, wq = warp % TMA_GROUP_WARPS;
  const int rh = grp & 1, ch = grp >> 1;
  const int g = lane >> 2, t4 = lane & 3, gt = threadIdx.x % 128;
  wg::grid_wait();
  wg::grid_launch();
  for (int c = threadIdx.x; c < BN; c += 32 * CW) {
    sBias[c] = p.bias[n0 + c];
    if (STAGE != 3) sGo[c] = p.g_out[n0 + c], sBo[c] = p.b_out[n0 + c];
  }
  if constexpr (STAGE == 1)
    for (int c = threadIdx.x; c < p.C; c += 32 * CW) sLnG[c] = p.g[c], sLnB[c] = p.b[c];
  const int gm0 = m0 + 64 * rh;  // the group's rows
  float2* gStat = sStat + 64 * rh;
  if constexpr (STAGE == 1) {  // LayerNorm 1's statistics, by the groups of column half 0
    float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};  // even and odd chunks
    for (int i = 0; i < base; ++i) {
      wg::mbar_wait(&full[i % S], (i / S) & 1);
      if (ch == 0) box_sums(smem + (i % S) * STG + rh * A_BOX, gt, s[i & 1], s2[i & 1]);
      bt::release(&empty[i % S], lane);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
      s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], 1);
    }
    const int r = gt >> 1;
    if (ch == 0 && (gt & 1) == 0) {
      const bool in = gm0 + r < M;
      gStat[r] = in ? ln_stats(s[0] + s[1], s2[0] + s2[1], p.C) : make_float2(0.f, -1.f);
      if (in && p.stats_a && blockIdx.x == 0) p.stats_a[gm0 + r] = gStat[r];
    }
    wg::bar_sync(2 + rh, NH * 128);
  }

  int lpos[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lpos[k] = (gm0 + gt / 8 + 16 * k) % L;
  const int first = gm0 % L, mid = (p.taps - 1) / 2;

  float acc[16][4];
  for (int c = 0; c < n_chunks; ++c) {
    const int i = base + c, s = i % S, t = c / cpt;
    wg::mbar_wait(&full[s], (i / S) & 1);
    unsigned char* st = smem + s * STG;
    unsigned char* a_rows = st + rh * A_BOX;
    bool rewritten = false;
    if constexpr (STAGE == 1) {  // the row half's groups take alternate cells
      ln_act_box<NH>(a_rows, gStat, sLnG, sLnB, c % cpt, gt, p.gelu, NH == 1 ? 0 : ch);
      rewritten = true;
    } else {
      const int shift = (t - mid) * p.dil;
      if (bt::crosses(first, shift, L)) {  // the same zeros, written by each group of the half
        bt::zero_rows(a_rows, lpos, shift, L, gt);
        rewritten = true;
      }
    }
    if (rewritten) {
      wg::fence_proxy();
      wg::bar_sync(2 + rh, NH * 128);
    }
    const uint64_t da = wg::desc(a_rows, 0, 1024);
    const uint64_t db = wg::desc(st + WideSmem::A + ch * 128 * 128, 0, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n128<0>(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 32 * kk),
                         c > 0 || kk > 0);
    wg::commit();
    wg::wait<1>();  // the previous chunk is done
    if (c > 0) bt::release(&empty[(i - 1) % S], lane);
  }
  wg::wait<0>();
  bt::release(&empty[(base + n_chunks - 1) % S], lane);
  wg::fence_acc(acc);

  // the products into shared memory over the first stages, zero past the rows
  wg::bar_sync(1, CW * 32);  // every group's products are done
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 64 * rh + 16 * wq + g + 8 * hh;
    const bool in = m0 + r < M;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(sD.at(r, 128 * ch + 8 * j + 2 * t4)) =
          in ? make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]) : make_float2(0.f, 0.f);
  }
  const int c4 = 4 * lane;  // the lane's four columns of each 128 of a row
  uint2 res[STAGE == 3 ? WR : 1][NH];
  if constexpr (STAGE == 3)  // the residual's rows, its loads all in flight together
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int m = m0 + warp + CW * i;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        res[i][h] = m < M ? *reinterpret_cast<const uint2*>(p.x + (size_t)m * p.N + n0 +
                                                            128 * h + c4)
                          : make_uint2(0, 0);
    }
  wg::bar_sync(1, CW * 32);

  // a warp a row: bias, residual, rounding (kept in place), out; the
  // rounded values' sums over the tile's columns
  float4 b4[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) b4[h] = *reinterpret_cast<const float4*>(sBias + 128 * h + c4);
#pragma unroll 2
  for (int i = 0; i < WR; ++i) {
    const int r = warp + CW * i, m = m0 + r;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int c = 128 * h + c4;
      float4* dp = reinterpret_cast<float4*>(sD.at(r, c));
      float4 d = *dp;
      if constexpr (STAGE == 3) {
        const float4 x4 = bt::unpack4(res[i][h]);
        d = make_float4(x4.x + (d.x + b4[h].x), x4.y + (d.y + b4[h].y), x4.z + (d.z + b4[h].z),
                        x4.w + (d.w + b4[h].w));
      } else {
        d = make_float4(d.x + b4[h].x, d.y + b4[h].y, d.z + b4[h].z, d.w + b4[h].w);
      }
      d = make_float4(to_f(from_f<bf16>(d.x)), to_f(from_f<bf16>(d.y)), to_f(from_f<bf16>(d.z)),
                      to_f(from_f<bf16>(d.w)));
      if (m < M && p.out) bt::store4(p.out + (size_t)m * p.N + n0 + c, d.x, d.y, d.z, d.w);
      if constexpr (STAGE != 3) {
        *dp = d;
        s1 += (d.x + d.y) + (d.z + d.w);
        s2 += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
      }
    }
    if constexpr (STAGE != 3) {
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) sRow[r] = make_float2(s1, s2);
    }
  }
  if constexpr (STAGE != 3) {
    const float2 tot = bt::cluster_row_sums<BM>(sRow, cluster);
    if (threadIdx.x < BM) {
      const int r = threadIdx.x;
      sStat[r] = ln_stats(tot.x, tot.y, p.N);
      if (p.stats_out && blockIdx.x == 0 && m0 + r < M) p.stats_out[m0 + r] = sStat[r];
    }
    wg::bar_sync(1, CW * 32);
    // a warp a row: act_out = bf16(act(LN(out))) from the rounded values
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int c = 128 * h + c4;
      const float4 go = *reinterpret_cast<const float4*>(sGo + c);
      const float4 bo = *reinterpret_cast<const float4*>(sBo + c);
#pragma unroll 2
      for (int i = 0; i < WR; ++i) {
        const int r = warp + CW * i, m = m0 + r;
        if (m >= M) continue;
        const float2 st = sStat[r];
        const float4 d = *reinterpret_cast<const float4*>(sD.at(r, c));
        bt::store4(p.act_out + (size_t)m * p.N + n0 + c,
                   act_fn(ln_affine(d.x, st, go.x, bo.x), p.gelu),
                   act_fn(ln_affine(d.y, st, go.y, bo.y), p.gelu),
                   act_fn(ln_affine(d.z, st, go.z, bo.z), p.gelu),
                   act_fn(ln_affine(d.w, st, go.w, bo.w), p.gelu));
      }
    }
  }
}

// The kernel of launch `stage` (1-3) of a design: `bm`-row tiles of `bn`
// columns
template <int STAGE> const void* kernel_of(int bm, int bn) {
  if (bm == WIDE_BM)
    return bn == 256 ? (const void*)wgmma_wide_bytenet_fwd_gemm_kernel<STAGE, 256>
                     : (const void*)wgmma_wide_bytenet_fwd_gemm_kernel<STAGE, 128>;
  return bn == 64 ? (const void*)wgmma_bytenet_fwd_gemm_kernel<STAGE, 64>
                  : (const void*)wgmma_bytenet_fwd_gemm_kernel<STAGE, 128>;
}
const void* tma_kernel(int stage, int bm, int bn) {
  return stage == 1   ? kernel_of<1>(bm, bn)
         : stage == 2 ? kernel_of<2>(bm, bn)
                      : kernel_of<3>(bm, bn);
}
int tma_smem(int bm, int bn, int stages) {
  return bm == WIDE_BM ? WideSmem{stages, bn}.bytes() : TmaSmem{stages, bn}.bytes();
}

// Each Hopper kernel's limit on dynamic shared memory, set once for all
// twelve (the first call of a process is eager: a graph capture sets nothing)
cudaError_t tma_limits() {
  static const cudaError_t err = [] {
    const int designs[4][3] = {{TMA_BM, 64, TMA_STAGES[1]}, {TMA_BM, TMA_BN, TMA_STAGES[1]},
                               {WIDE_BM, TMA_BN, WIDE_STAGES[1]}, {WIDE_BM, 256, WIDE_STAGES_256}};
    for (int stage = 1; stage <= 3; ++stage)
      for (const auto& d : designs) {
        const cudaError_t e =
            cudaFuncSetAttribute(tma_kernel(stage, d[0], d[1]),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 tma_smem(d[0], d[1], d[2]));
        if (e != cudaSuccess) return e;
      }
    return cudaSuccess;
  }();
  return err;
}

bool one_of(long long v, const int (&set)[2]) { return v == set[0] || v == set[1]; }

// The plan of one launch as the caller computed it
// (ops/fused_bytenet.py::bytenet_block_plan), PLAN_LEN values: grid x, y,
// z, cluster x, threads, shared-memory bytes, the tile's rows BM (64 or
// 128: the design) and columns BN (64 or 128; 128 or 256), the ring's stages, whether the launch
// may start under the previous one's tail (programmatic dependent launch,
// 0 or 1), the A rows' map (dims, innermost first, byte stride, box) and
// the weight map's (the same). The design, BN, stages and launch mode are
// choices; the rest follows from them and the shape.
constexpr int PLAN_LEN = 20;

// The launch configuration of a plan's launch (its cluster, and the
// programmatic launch where the plan asks for it)
struct LaunchCfg {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  LaunchCfg(const long long* lp, cudaStream_t stream) {
    cfg.gridDim = dim3((unsigned)lp[0], (unsigned)lp[1], (unsigned)lp[2]);
    cfg.blockDim = dim3((unsigned)lp[4]);
    cfg.dynamicSmemBytes = (size_t)lp[5];
    cfg.stream = stream;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = (unsigned)lp[3];
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = lp[9] ? 2 : 1;
  }
};

// Refuse a plan other than this source's own for the launch, then launch it
cudaError_t launch_tma(int stage, const long long* plan, const void* a_rows, const void* w,
                       TmaFwdArgs args, cudaStream_t stream) {
  const long long C = args.C, N = args.N, M = args.M, taps = args.taps;
  const long long bm = plan[6], bn = plan[7], stages = plan[8], pdl = plan[9];
  const bool wide = bm == WIDE_BM;
  const bool tiles_ok = wide ? (bn == TMA_BN && one_of(stages, WIDE_STAGES)) ||
                                   (bn == 256 && stages == WIDE_STAGES_256)
                             : (bn == 64 || bn == TMA_BN) && one_of(stages, TMA_STAGES);
  if ((bm != TMA_BM && !wide) || !tiles_ok || (pdl != 0 && pdl != 1) || N % bn ||
      C % 64 || C > TMA_MAX_C || reinterpret_cast<uintptr_t>(a_rows) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  args.stages = (int)stages;
  const long long tiles_n = N / bn, smem = tma_smem((int)bm, (int)bn, (int)stages);
  const long long threads = bn == 256 ? wide_threads<256>() : TMA_THREADS;
  const long long want[PLAN_LEN] = {tiles_n, (M + bm - 1) / bm, 1, stage == 3 ? 1 : tiles_n,
                                    threads, smem, bm, bn, stages, pdl,
                                    C, M, C * 2, 64, bm,
                                    taps * C, N, taps * C * 2, 64, bn};
  for (int i = 0; i < PLAN_LEN; ++i)
    if (plan[i] != want[i]) return cudaErrorInvalidValue;
  if (want[3] > MAX_CLUSTER || smem > TMA_MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  const cuuint64_t a_dims[2] = {(cuuint64_t)plan[10], (cuuint64_t)plan[11]};
  const cuuint64_t a_strides[1] = {(cuuint64_t)plan[12]};
  const cuuint32_t a_box[2] = {(cuuint32_t)plan[13], (cuuint32_t)plan[14]};
  const cuuint64_t w_dims[2] = {(cuuint64_t)plan[15], (cuuint64_t)plan[16]};
  const cuuint64_t w_strides[1] = {(cuuint64_t)plan[17]};
  const cuuint32_t w_box[2] = {(cuuint32_t)plan[18], (cuuint32_t)plan[19]};
  if (!wg::encode(&ma, a_rows, 2, a_dims, a_strides, a_box) ||
      !wg::encode(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  LaunchCfg lc(plan, stream);
  void* params[3] = {&ma, &mw, &args};
  const cudaError_t err = cudaLaunchKernelExC(&lc.cfg, tma_kernel(stage, (int)bm, (int)bn), params);
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
// ops/fused_bytenet.py::bytenet_block_plan gives these designs). Arguments
// as hd_bytenet_block_fwd's, without dtype; x, w1, wc, w2 and the scratch
// bb, e at 16-byte aligned addresses (TMA); `plan` the three launches'
// plans (3 x PLAN_LEN values, F1, F2, F3), each refused unless it is this
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

// How the three launches of a Hopper K2 `plan` fit the card: out[i] the
// clusters of launch i that can be resident at once
// (cudaOccupancyMaxActiveClusters); returns a cudaError_t code
extern "C" int hd_bytenet_block_fwd_occupancy(const long long* plan, int* out) {
  cudaError_t err = tma_limits();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 3; ++i) {
    const long long* lp = plan + i * PLAN_LEN;
    if ((lp[6] != TMA_BM && lp[6] != WIDE_BM) || (lp[7] != 64 && lp[7] != TMA_BN && lp[7] != 256))
      return (int)cudaErrorInvalidValue;
    LaunchCfg lc(lp, nullptr);
    lc.cfg.numAttrs = 1;  // the cluster alone
    if ((err = cudaOccupancyMaxActiveClusters(&out[i], tma_kernel(i + 1, (int)lp[6], (int)lp[7]),
                                              &lc.cfg)) != cudaSuccess)
      return (int)err;
  }
  return 0;
}
