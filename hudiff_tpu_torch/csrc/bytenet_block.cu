// K2: the ByteNet residual block forward, as three launches, one GEMM each,
// with every LayerNorm + activation folded into a GEMM.
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
// B=16 the three GEMMs are small, so launches, latency and any work repeated
// per tile are what cost.
//
// Design (gemm_tiles.cuh's pipelined core; one kernel, bytenet_fwd_gemm_kernel):
//   F1: p = cd(act(LN1 x) W1^T + c1). The block takes its rows' LN1
//       statistics in a prologue (it reads those x rows anyway) and applies
//       act(LN1 .) to each A chunk as it lands.
//   F2: q = cd(im2col(bb) Wc^T + cc), Wc laid out [out][K][in], i.e. a
//       [H, K*H] matrix: A's row m, tap t is row m + (t - (K-1)/2) dil of the
//       same chain, zero outside it: the zero of bb, as _fwd_kernel masks bb
//       (pallas_bytenet.py:174-178).
//   F3: y = cd(x + e W2^T + c2).
// F1 and F2 finish the next LayerNorm in their epilogues: the blocks that
// share a row tile run as one thread-block cluster across all column tiles,
// each puts its rows' (sum, sum of squares) of the rounded output in shared
// memory, and every block reads all of them through distributed shared
// memory, in rank order, so all hold the same statistics; each then writes
// bb = cd(act(LN2 p)) (F1) or e = cd(act(LN3 q)) (F2) beside p or q. So
// each activated element is formed once, where its value is in registers,
// and F2 and F3 read plain rows: forming bb on load instead cost every
// column tile of every tap a LayerNorm pass over its A chunk. The three
// LayerNorms' row statistics, which the kernels hold anyway, are written
// out when asked: K4 takes them as residuals. Rounding points
// stay where the TPU kernel has them: p, bb, q, e and y in cd, the
// statistics taken from the rounded p and q. Tiles: 64 x 64 (8 warps of
// 32 x 16) unless 128 x 128 tiles (8 warps of 64 x 32) still give two blocks
// per SM; chunks of 128 bytes per row, swizzled, in a three-slot cp.async
// ring; nothing is atomic, so a call repeats to the same bits. f32 inputs
// take the FMA path of the same kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_tiles.cuh"

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
