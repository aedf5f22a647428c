// K8: a whole attention layer, x Wqkv + bqkv -> RoPE attention -> Wout +
// bout, forward only, in two launches.
//
// Replaces tools/fused_layer_probe.py::_fused_layer_kernel (pallas_call at
// :75; called through fused_layer).
//
// What it computes, per batch row b, with T the type of x and of every
// weight (f32 or bf16) and every product of T values accumulated in f32;
// the rounding points are the TPU kernel's:
//   qkv = T(T(x Wqkv) + bqkv)                   Wqkv [dm, 3A] column-blocked:
//                                               q | k | v, head h at h*64
//   per head h: q, k = T(rope(q_h)), T(rope(k_h)) (f32 rotation, each product
//                                               and sum rounded on its own as
//                                               tc::rope_pair rounds them)
//               o_h  = T(softmax(q k^T * scale) v), P rounded to T
//   y   = T(T(concat_h o_h  Wout) + bout)       Wout [A, dm]
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): operations. At B=64, L=291, dm 768, A 512 (8 heads), bf16, one
// call is 43.9 GFLOP of qkv projection, 11.1 of attention and 14.6 of out
// projection: 69.7 GFLOP, 0.0705 ms at 989 TFLOP/s, against ~60 MB of x, y
// and weights (0.018 ms at 3.35 TB/s; 0.029 ms with o written and read).
// 84% of the operations are two plain GEMMs, which only wgmma runs at the
// card's tensor-core rate.
//
// bf16 design (wgmma_tiles.cuh; raw PTX). The TPU kernel held the weights and
// one batch row in VMEM and did the whole layer per row. On Hopper x[b] is
// 447 KB and Wqkv 2.4 MB against 227 KB of shared memory a block, and the
// out projection sums over heads, which blocks cannot share. So two
// launches, each a block of two consumer warpgroups and one producer warp
// (288 threads): the producer's lane 0 keeps a ring of 32 KB stages full
// with TMA bulk tensor copies (cp.async.bulk.tensor, 128-byte swizzle,
// completion on an mbarrier per stage); the consumers run
// wgmma.mma_async m64nNk16 on the landed stage, straight from shared
// memory, and free it through a second mbarrier. No thread spends registers
// or instructions on a load, and the next stages' copies run while the
// tensor cores work.
//   (1) fused_layer_attn_wgmma_kernel, one block per (h, b): 512 blocks at
//       B=64, one block an SM (shared memory), 3.9 waves over 132 SMs.
//       Phase A projects k and v of head h for every row, 128 rows a pass
//       (each warpgroup 64; N = 128: the two 64-column boxes of Wqkv at
//       A + 64h and 2A + 64h, read as one N-major operand), through a
//       three-stage ring of x[b] row tiles and Wqkv tiles. x's tensor map is
//       3-D [B][L][dm], so rows past L come back as TMA's zero fill, not as
//       the next batch row's. The register epilogue adds the bias in T,
//       rotates k (the pairs c, c + 32 sit in one thread) and stores K and
//       V in shared memory as 128-byte-swizzled rows (rows >= L zero).
//       Phase B projects q the same way, 128 rows a pass (N = 64), adds the
//       bias and rotates in registers, and repacks the accumulator straight
//       into A fragments (tc::to_a: a warp's wgmma accumulator is the m16n8
//       layout), so q never touches shared memory. Then each warpgroup runs
//       K1's online softmax over the held K and V on wgmma with A from
//       registers: S = q k^T (K the K-major operand) and O += P V (V the
//       N-major one), S and P in registers, keys >= L masked. o_h is
//       written in T, staged and stored 16 bytes a lane; qkv never reaches
//       device memory. Shared memory at L = 291: the ring 96 KB, output
//       staging 18 KB, K and V 80 KB (2 x 320 rows x 128 B): 195 KB a block.
//       K and V stay in shared memory up to L = 384; past that they go to a
//       workspace the wrapper allocates (hd_fused_layer_workspace_bytes),
//       and each warpgroup copies one K and one V tile at a time into a
//       swizzled window (cp.async). ptxas: 168 registers, no spills.
//       What holds it back: the projections re-read x[b] twice and their
//       head's Wqkv columns once per 128-row pass from L2 (1.8 MB a block,
//       0.9 GB a call), and the attention's chain of dependent products and
//       softmax steps per key tile, which runs after the projection of its
//       rows, not beside it.
//   (2) fused_layer_out_wgmma_kernel: o [B*L, A] x Wout [A, dm], persistent
//       (one block an SM walks 128 x 128 output tiles; the producer runs
//       into the next tile while the consumers finish this one), a
//       four-stage ring of o row tiles (2-D map; rows past B*L zero-filled)
//       and two 64-column Wout boxes, y = T(T(acc) + bout) in registers,
//       staged and stored 16 bytes a lane.
// No atomics: every output is summed in a fixed order, so a repeat gives
// the same bits. o reaches device memory (19 MB at B=64).
//
// f32 (the tests' type) keeps the earlier exact FMA path: wgmma has no exact f32.
// One block per (h, b) projects q, k, v 64 rows at a time from synchronous
// tile loads (attention_tiles.cuh's FMA Acc), keeps them in a workspace
// (one head's q, k, v at L 291 take 261 KB), runs the online softmax over
// f32 shared tiles, and a 64 x 64 tiled GEMM makes y.

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

using namespace hd;

namespace {

constexpr int BT = 64;  // rows or columns per tile

// ---- f32: the exact FMA path --------------------------------------------

struct AttnSmemF32 {
  static constexpr int LDT = ldt<float>();
  static constexpr int TILE = round_up(BT * LDT * 4, 128);
  static constexpr int FTILE = round_up(BT * LDF * 4, 128);
  // projection: an x tile, three Wqkv tiles, one f32 epilogue tile;
  // attention: S, P, O; the two phases share the space
  static constexpr int A_BYTES = 4 * TILE + FTILE;
  static constexpr int B_BYTES = 3 * FTILE;
  static constexpr int BYTES = A_BYTES > B_BYTES ? A_BYTES : B_BYTES;
  // q, k, v of one (b, h) in the workspace, each [round_up(L, 64)][LDT]
  static size_t buf_bytes(int L) { return (size_t)3 * round_up(L, BT) * LDT * 4; }
};

struct AttnArgsF32 {
  const float *x, *wqkv, *bqkv;
  const float *cos_t, *sin_t;  // [L, 32] f32
  float* o;                    // [B, L, A]
  float* ws;                   // q, k, v per (b, h)
  int L, dm, H;
  float scale;
};

__device__ __forceinline__ void layer_attn_f32(const AttnArgsF32& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = AttnSmemF32;
  constexpr int LDT = SM::LDT, V = Cfg<float>::VEC;
  const int h = blockIdx.x, b = blockIdx.y, H = a.H, L = a.L, dm = a.dm, A = H * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, Lp = round_up(L, BT);
  float* buf = a.ws + ((size_t)b * H + h) * 3 * Lp * LDT;

  // -- projection: q, k, v of head h, 64 rows at a time -------------------
  float* sX = reinterpret_cast<float*>(smem);
  float* sE = reinterpret_cast<float*>(smem + 4 * SM::TILE);
  const float* x = a.x + (size_t)b * L * dm;
  for (int r0 = 0; r0 < Lp; r0 += BT) {
    Acc<float> acc[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[g].zero();
    for (int k0 = 0; k0 < dm; k0 += BT) {
      __syncthreads();  // previous tiles fully read
      for (int idx = threadIdx.x; idx < BT * (HD / V); idx += THREADS) {
        const int r = idx / (HD / V), c = (idx % (HD / V)) * V, l = r0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (l < L) val = *reinterpret_cast<const uint4*>(x + (size_t)l * dm + k0 + c);
        *reinterpret_cast<uint4*>(sX + r * LDT + c) = val;
      }
      for (int idx = threadIdx.x; idx < 3 * BT * (HD / V); idx += THREADS) {
        const int g = idx / (BT * (HD / V)), rem = idx % (BT * (HD / V));
        const int r = rem / (HD / V), c = (rem % (HD / V)) * V;
        float* sW = reinterpret_cast<float*>(smem + (1 + g) * SM::TILE);
        *reinterpret_cast<uint4*>(sW + r * LDT + c) = *reinterpret_cast<const uint4*>(
            a.wqkv + (size_t)(k0 + r) * 3 * A + g * A + h * HD + c);
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < 3; ++g)
        acc[g].ab(sX, reinterpret_cast<const float*>(smem + (1 + g) * SM::TILE), warp, lane);
    }
    // epilogue, on the warp's own 16 rows: qkv = acc + bias; q and k
    // rotated (tc::rope_pair); rows >= L stored as zeros (unrolled: acc[g]
    // stays in registers)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      __syncwarp();
      acc[g].store(sE, warp, lane);
      __syncwarp();
      const float b0 = a.bqkv[g * A + h * HD + lane];
      const float b1 = a.bqkv[g * A + h * HD + lane + D2];
      float* dst = buf + (size_t)g * Lp * LDT;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r, l = r0 + row;
        float lo = 0.f, hi = 0.f;
        if (l < L) {
          const float e0 = sE[row * LDF + lane] + b0, e1 = sE[row * LDF + lane + D2] + b1;
          if (g < 2) {
            const float2 rot =
                tc::rope_pair(e0, e1, a.cos_t[l * D2 + lane], a.sin_t[l * D2 + lane]);
            lo = rot.x, hi = rot.y;
          } else {
            lo = e0, hi = e1;
          }
        }
        dst[(size_t)l * LDT + lane] = lo;
        dst[(size_t)l * LDT + lane + D2] = hi;
      }
    }
  }
  __syncthreads();  // every q, k, v row written; the scratch is free again

  // -- attention over the held q, k, v: the online softmax in f32 tiles ---
  float* sS = reinterpret_cast<float*>(smem);
  float* sP = reinterpret_cast<float*>(smem + SM::FTILE);
  float* sO = reinterpret_cast<float*>(smem + 2 * SM::FTILE);
  const float* bq = buf;
  const float* bk = buf + (size_t)Lp * LDT;
  const float* bv = buf + (size_t)2 * Lp * LDT;
  float* o = a.o + (size_t)b * L * A + h * HD;
  Acc<float> acc;
  for (int q0 = 0; q0 < L; q0 += BT) {
    float m_run[16], l_run[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m_run[r] = -INFINITY, l_run[r] = 0.f;
      sO[(warp * 16 + r) * LDF + lane] = sO[(warp * 16 + r) * LDF + lane + D2] = 0.f;
    }
    __syncwarp();
    for (int k0 = 0; k0 < L; k0 += BT) {
      acc.zero();
      acc.abt(bq + (size_t)q0 * LDT, bk + (size_t)k0 * LDT, warp, lane);
      acc.store(sS, warp, lane);
      __syncwarp();
      softmax_tile(sS, sP, sO, m_run, l_run, k0, L, a.scale, warp, lane);
      __syncwarp();
      acc.load(sO, warp, lane);
      acc.ab(sP, bv + (size_t)k0 * LDT, warp, lane);
      acc.store(sO, warp, lane);
      __syncwarp();
    }
    store_rows(o, A, sO, l_run, q0, L, warp, lane);
    __syncwarp();
  }
}

struct OutArgsF32 {
  const float *o, *wout, *bout;
  float* y;
  int M, A, dm;  // o [M, A], Wout [A, dm], y [M, dm]
};

struct OutSmemF32 {
  static constexpr int BYTES = 2 * AttnSmemF32::TILE + AttnSmemF32::FTILE;
};

// y[m0 + 64 rows, n0 + 64 columns] = o Wout + bout
__device__ __forceinline__ void layer_out_f32(const OutArgsF32& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDT = ldt<float>(), V = Cfg<float>::VEC;
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + AttnSmemF32::TILE);
  float* sC = reinterpret_cast<float*>(smem + 2 * AttnSmemF32::TILE);
  const int n0 = blockIdx.x * BT, m0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Acc<float> acc;
  acc.zero();
  for (int k0 = 0; k0 < a.A; k0 += BT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * (HD / V); idx += THREADS) {
      const int r = idx / (HD / V), c = (idx % (HD / V)) * V, m = m0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < a.M) val = *reinterpret_cast<const uint4*>(a.o + (size_t)m * a.A + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * LDT + c) = val;
      *reinterpret_cast<uint4*>(sB + r * LDT + c) =
          *reinterpret_cast<const uint4*>(a.wout + (size_t)(k0 + r) * a.dm + n0 + c);
    }
    __syncthreads();
    acc.ab(sA, sB, warp, lane);
  }
  acc.store(sC, warp, lane);
  __syncwarp();
  const float b0 = a.bout[n0 + lane], b1 = a.bout[n0 + lane + 32];
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, m = m0 + row;
    if (m < a.M) {
      float* d = a.y + (size_t)m * a.dm + n0;
      d[lane] = sC[row * LDF + lane] + b0;
      d[lane + 32] = sC[row * LDF + lane + 32] + b1;
    }
  }
}

__global__ void __launch_bounds__(THREADS) fused_layer_attn_f32_kernel(AttnArgsF32 a) {
  layer_attn_f32(a);
}
__global__ void __launch_bounds__(THREADS) fused_layer_out_f32_kernel(OutArgsF32 a) {
  layer_out_f32(a);
}

// ---- bf16: wgmma fed by TMA ---------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int BM = 128;                  // rows a stage carries: two warpgroups x 64
constexpr int BK = 64;                   // depth a stage carries (one 128-byte row)
constexpr int CONSUMER_WARPS = 8;        // two warpgroups
constexpr int WG_THREADS = (CONSUMER_WARPS + 1) * 32;  // and one producer warp
constexpr int X_BOX = BM * BK * 2;       // 16 KB: 128 rows of x or o
constexpr int W_BOX = BK * 64 * 2;       // 8 KB: 64 k x 64 columns of a weight
constexpr int STAGE = X_BOX + 2 * W_BOX;
constexpr int LDK = tc::LD;              // output staging row stride (elements)
constexpr int ATTN_STAGES = 3, OUT_STAGES = 4;
constexpr int OUT_BN = 128, OUT_LD = OUT_BN + 8;

// Launch 1's shared memory from the aligned base: the ring, the output
// staging (16 rows a warp), K and V (or the two warpgroups' windows), the
// ring's mbarriers.
struct AttnSmem {
  static constexpr int STAGING = ATTN_STAGES * STAGE;
  static constexpr int KV = STAGING + CONSUMER_WARPS * 16 * LDK * 2;
  static constexpr int KV_TILE = BT * 128;          // 64 rows of K or V, 128-byte swizzle
  static constexpr int WINDOWS = 2 * 2 * KV_TILE;   // a K and a V tile per warpgroup
  static constexpr int BARS = 2 * ATTN_STAGES * 8;
  static long long kv_bytes(int L) { return 2LL * round_up(L, BT) * 128; }
  static bool in_smem(int L) { return KV + kv_bytes(L) + BARS + wg::SMEM_SLACK <= MAX_SMEM; }
  static int kv_region(int L) { return in_smem(L) ? (int)kv_bytes(L) : WINDOWS; }
  static int bytes(int L) { return KV + kv_region(L) + BARS + wg::SMEM_SLACK; }
  // K then V of one (b, h), [round_up(L, 64), 64] each, when they do not fit
  static long long ws_bytes(int L) { return 2LL * round_up(L, BT) * HD * 2; }
};

struct OutSmem {
  static constexpr int STAGING = OUT_STAGES * STAGE;
  static constexpr int BARS_AT = STAGING + CONSUMER_WARPS * 16 * OUT_LD * 2;
  static constexpr int BYTES = BARS_AT + 2 * OUT_STAGES * 8 + wg::SMEM_SLACK;
};

struct AttnArgs {
  const bf16* bqkv;
  const float *cos_t, *sin_t;  // [L, 32] f32
  bf16* o;                     // [B, L, A]
  bf16* ws;                    // K and V per (b, h) when they do not fit, else nullptr
  int L, dm, H, kv_region;
  float scale;
};

struct OutArgs {
  const bf16* bout;
  bf16* y;
  int M, A, dm, tiles_n, tiles;  // o [M, A], Wout [A, dm], y [M, dm]; 128 x 128 tiles
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A ring of S stages between the producer's lane and the consumer warps:
// full[s] completes when stage s's copies have landed, empty[s] when every
// consumer warp is done with it. Both sides walk the same sequence of
// stages; the parity flips each time the walk wraps.
template <int S> struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int s = 0;
  uint32_t ph = 0;
  __device__ Ring(unsigned char* bars) : full(reinterpret_cast<uint64_t*>(bars)), empty(full + S) {}
  __device__ void init() {
    for (int i = 0; i < S; ++i) wg::mbar_init(&full[i], 1), wg::mbar_init(&empty[i], CONSUMER_WARPS);
    wg::mbar_fence_init();
  }
  __device__ void next() {
    if (++s == S) s = 0, ph ^= 1;
  }
  // producer: wait for stage s to be free and expect `bytes` in it
  __device__ uint64_t* acquire(uint32_t bytes) {
    wg::mbar_wait(&empty[s], ph ^ 1);
    wg::mbar_arrive_expect(&full[s], bytes);
    return &full[s];
  }
  __device__ void wait_full() { wg::mbar_wait(&full[s], ph); }
  // consumer warp: done with stage s
  __device__ void release(int lane) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }
};

// One warpgroup's 64 x N product over n_k stages of depth 64: A is the
// group's 64 rows of each stage's 128-row tile, B the stage's N columns
// (N / 64 boxes, W_BOX apart). Each stage is freed as soon as its products
// are done. A group with no rows (`live` false) only frees the stages.
template <int J, int S>
__device__ __forceinline__ void project(float (&acc)[J][4], Ring<S>& ring,
                                        const unsigned char* smem, int n_k, int grp, bool live,
                                        int lane) {
  for (int ks = 0; ks < n_k; ++ks) {
    ring.wait_full();
    if (live) {
      const unsigned char* st = smem + ring.s * STAGE;
      const uint64_t da = wg::desc(st + grp * (X_BOX / 2), 0, 1024);
      const uint64_t db = wg::desc(st + X_BOX, W_BOX, 1024);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int accumulate = ks > 0 || kk > 0;
        if constexpr (J == 16)
          wg::mma_m64n128(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 2048 * kk),
                          accumulate);
        else
          wg::mma_m64n64(acc, wg::desc_add(da, 32 * kk), wg::desc_add(db, 2048 * kk),
                         accumulate);
      }
      wg::commit();
      wg::wait<0>();
    }
    ring.release(lane);
    ring.next();
  }
  wg::fence_acc(acc);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_layer_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                                  const __grid_constant__ CUtensorMap map_w, AttnArgs a) {
  unsigned char* smem = wg::aligned_smem();
  const int h = blockIdx.x, b = blockIdx.y, L = a.L, A = a.H * HD;
  const int n_t = (L + BM - 1) / BM, n_k = a.dm / BK, Lk = round_up(L, BT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring<ATTN_STAGES> ring(smem + AttnSmem::KV + a.kv_region);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: lane 0 issues every copy
    if (lane != 0) return;
    wg::tma_prefetch(&map_x);
    wg::tma_prefetch(&map_w);
    for (int pass = 0; pass < 2; ++pass)  // k and v of every row, then q
      for (int t = 0; t < n_t; ++t)
        for (int ks = 0; ks < n_k; ++ks) {
          unsigned char* st = smem + ring.s * STAGE;
          uint64_t* bar = ring.acquire(pass == 0 ? STAGE : X_BOX + W_BOX);
          wg::tma_load_3d(st, &map_x, bar, ks * BK, t * BM, b);
          if (pass == 0) {
            wg::tma_load_2d(st + X_BOX, &map_w, bar, A + h * HD, ks * BK);
            wg::tma_load_2d(st + X_BOX + W_BOX, &map_w, bar, 2 * A + h * HD, ks * BK);
          } else {
            wg::tma_load_2d(st + X_BOX, &map_w, bar, h * HD, ks * BK);
          }
          ring.next();
        }
    return;
  }

  const int grp = warp / 4, wq = warp % 4, g = lane >> 2, t4 = lane & 3;
  // K and V: in shared memory as 128-byte-swizzled rows (the layout the
  // attention's wgmma reads), or as plain rows in the workspace
  const bool held = a.ws == nullptr;
  unsigned char* kv = smem + AttnSmem::KV;
  bf16* k_ws = held ? nullptr : a.ws + ((size_t)b * a.H + h) * 2 * Lk * HD;
  bf16* v_ws = held ? nullptr : k_ws + (size_t)Lk * HD;
  auto put = [&](int which, int l, int c, uint32_t val) {  // 2 elements of K (0) or V (1)
    if (held)
      *reinterpret_cast<uint32_t*>(kv + which * Lk * 128 + wg::swizzle128(l, c)) = val;
    else
      *reinterpret_cast<uint32_t*>((which ? v_ws : k_ws) + (size_t)l * HD + c) = val;
  };
  const bf16* bk = a.bqkv + A + h * HD;
  const bf16* bv = a.bqkv + 2 * A + h * HD;
  const bf16* bq = a.bqkv + h * HD;

  // -- phase A: k and v of head h for every row ---------------------------
  for (int t = 0; t < n_t; ++t) {
    const int row0 = t * BM + grp * 64;
    const bool live = row0 < L;  // the last pass may leave a group no rows
    float acc[16][4];            // columns [0, 64): k, [64, 128): v
    project(acc, ring, smem, n_k, grp, live, lane);
    if (!live) continue;
    // k, v = T(T(acc) + bias), k rotated and rounded; rows >= L zero
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = row0 + wq * 16 + g + 8 * hh;  // < Lk: row0 < L, a multiple of 64
      const bool in = l < L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t4;
        float klo[2], khi[2], vlo[2], vhi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          klo[e] = round_bf16(round_bf16(acc[j][2 * hh + e]) + __bfloat162float(bk[c + e]));
          khi[e] = round_bf16(round_bf16(acc[j + 4][2 * hh + e]) +
                              __bfloat162float(bk[c + D2 + e]));
          vlo[e] = round_bf16(round_bf16(acc[8 + j][2 * hh + e]) + __bfloat162float(bv[c + e]));
          vhi[e] = round_bf16(round_bf16(acc[12 + j][2 * hh + e]) +
                              __bfloat162float(bv[c + D2 + e]));
          if (in) {
            const float2 r = tc::rope_pair(klo[e], khi[e], a.cos_t[l * D2 + c + e],
                                           a.sin_t[l * D2 + c + e]);
            klo[e] = r.x, khi[e] = r.y;
          }
        }
        put(0, l, c, in ? tc::pack(klo[0], klo[1]) : 0u);
        put(0, l, c + D2, in ? tc::pack(khi[0], khi[1]) : 0u);
        put(1, l, c, in ? tc::pack(vlo[0], vlo[1]) : 0u);
        put(1, l, c + D2, in ? tc::pack(vhi[0], vhi[1]) : 0u);
      }
    }
  }
  wg::fence_proxy();                 // K and V, stored by threads, are read by wgmma
  wg::bar_sync(1, CONSUMER_WARPS * 32);  // every K and V row written

  // -- phase B: q of 128 rows at a time, then attention over K and V ------
  const float sl2 = a.scale * tc::LOG2E;
  unsigned char* window = kv + grp * 2 * AttnSmem::KV_TILE;  // without `held`: K, then V
  bf16* staged = reinterpret_cast<bf16*>(smem + AttnSmem::STAGING) + warp * 16 * LDK;
  bf16* o_bh = a.o + (size_t)b * L * A + h * HD;
  for (int t = 0; t < n_t; ++t) {
    const int row0 = t * BM + grp * 64;
    const bool live = row0 < L;
    float acc[8][4];
    project(acc, ring, smem, n_k, grp, live, lane);
    if (!live) continue;
    // q = T(T(acc) + bias), rotated; to_a rounds it into the A fragments
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = row0 + wq * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          const float lo = round_bf16(round_bf16(acc[j][2 * hh + e]) + __bfloat162float(bq[c]));
          const float hi =
              round_bf16(round_bf16(acc[j + 4][2 * hh + e]) + __bfloat162float(bq[c + D2]));
          float2 r = make_float2(0.f, 0.f);
          if (l < L) r = tc::rope_pair(lo, hi, a.cos_t[l * D2 + c], a.sin_t[l * D2 + c]);
          acc[j][2 * hh + e] = r.x;
          acc[j + 4][2 * hh + e] = r.y;
        }
    }
    uint32_t qf[4][4];
    tc::to_a(qf, acc);

    // the group's 64 rows against every key tile on wgmma, A from registers:
    // S = q k^T and O += P V, S and P kept in registers for the online
    // softmax (K1's arithmetic)
    float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    tc::zero(o);
    for (int k0 = 0; k0 < L; k0 += BT) {
      const unsigned char *cK = kv + k0 * 128, *cV = kv + Lk * 128 + k0 * 128;
      if (!held) {  // this group's window: the next K and V tile from the workspace
        wg::bar_sync(2 + grp, 128);  // the group is done with the last tile
        for (int idx = threadIdx.x % 128; idx < 2 * BT * 8; idx += 128) {
          const int which = idx >> 9, r = (idx >> 3) % BT, ch = idx & 7;
          tc::cp_async16(window + which * AttnSmem::KV_TILE + wg::swizzle128(r, ch * 8),
                         (which ? v_ws : k_ws) + (size_t)(k0 + r) * HD + ch * 8, true);
        }
        tc::cp_async_commit();
        tc::cp_async_wait_all();
        wg::fence_proxy();
        wg::bar_sync(2 + grp, 128);
        cK = window, cV = window + AttnSmem::KV_TILE;
      }
      float s[8][4];
      const uint64_t dk = wg::desc(cK, 0, 1024), dv = wg::desc(cV, W_BOX, 1024);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S = q k^T, unscaled; K is the K-major operand
        wg::mma_m64n64_rs<0>(s, qf[kk], wg::desc_add(dk, 32 * kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(s);
      float alpha[2];
      tc::online_softmax(s, m, l, alpha, k0, L, sl2, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      uint32_t pf[4][4];
      tc::to_a(pf, s);  // P rounded to bf16
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // O += P V; V is the N-major operand
        wg::mma_m64n64_rs<1>(o, pf[kk], wg::desc_add(dv, 2048 * kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(o);
    }
    // o_h = T(O / l): the warp's 16 rows staged, then 16 bytes a lane
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    tc::stage(staged, 0, o, inv, lane);
    __syncwarp();
    tc::store_rows16(o_bh, A, staged, 0, row0 + wq * 16, L, lane);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_layer_out_wgmma_kernel(const __grid_constant__ CUtensorMap map_o,
                                 const __grid_constant__ CUtensorMap map_w, OutArgs a) {
  unsigned char* smem = wg::aligned_smem();
  const int n_k = a.A / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring<OUT_STAGES> ring(smem + OutSmem::BARS_AT);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane != 0) return;
    wg::tma_prefetch(&map_o);
    wg::tma_prefetch(&map_w);
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int m0 = tile / a.tiles_n * BM, n0 = tile % a.tiles_n * OUT_BN;
      for (int ks = 0; ks < n_k; ++ks) {
        unsigned char* st = smem + ring.s * STAGE;
        uint64_t* bar = ring.acquire(STAGE);
        wg::tma_load_2d(st, &map_o, bar, ks * BK, m0);
        wg::tma_load_2d(st + X_BOX, &map_w, bar, n0, ks * BK);
        wg::tma_load_2d(st + X_BOX + W_BOX, &map_w, bar, n0 + 64, ks * BK);
        ring.next();
      }
    }
    return;
  }

  const int grp = warp / 4, wq = warp % 4, g = lane >> 2, t4 = lane & 3;
  bf16* staged = reinterpret_cast<bf16*>(smem + OutSmem::STAGING) + warp * 16 * OUT_LD;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int m0 = tile / a.tiles_n * BM, n0 = tile % a.tiles_n * OUT_BN;
    float acc[16][4];
    project(acc, ring, smem, n_k, grp, true, lane);
    // y = T(T(acc) + bout), the warp's 16 x 128 staged, then 16 bytes a lane
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4, col = n0 + c;
      const float b0 = col < a.dm ? __bfloat162float(a.bout[col]) : 0.f;
      const float b1 = col + 1 < a.dm ? __bfloat162float(a.bout[col + 1]) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(staged + (g + 8 * hh) * OUT_LD + c) = tc::pack(
            round_bf16(acc[j][2 * hh]) + b0, round_bf16(acc[j][2 * hh + 1]) + b1);
    }
    __syncwarp();
    const int r0 = m0 + grp * 64 + wq * 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = lane + 32 * i, r = idx >> 4, ch = idx & 15, col = n0 + ch * 8;
      if (r0 + r < a.M && col < a.dm)
        *reinterpret_cast<uint4*>(a.y + (size_t)(r0 + r) * a.dm + col) =
            *reinterpret_cast<const uint4*>(staged + r * OUT_LD + ch * 8);
    }
    __syncwarp();
  }
}

// ---- host -------------------------------------------------------------------

// Each kernel's limit on dynamic shared memory, set once: the port drives
// one card per process. Launch 1's size depends on L, so its limit is the
// most a block may have.
cudaError_t set_limits(int dtype) {
  auto set = [](const void* k, int bytes) {
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  };
  if (dtype == 0) {
    static const cudaError_t a = set((const void*)fused_layer_attn_f32_kernel,
                                     AttnSmemF32::BYTES);
    static const cudaError_t b = set((const void*)fused_layer_out_f32_kernel,
                                     OutSmemF32::BYTES);
    return a != cudaSuccess ? a : b;
  }
  static const cudaError_t a = set((const void*)fused_layer_attn_wgmma_kernel, MAX_SMEM);
  static const cudaError_t b = set((const void*)fused_layer_out_wgmma_kernel, OutSmem::BYTES);
  return a != cudaSuccess ? a : b;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

struct Call {
  const void *x, *wqkv, *bqkv, *wout, *bout;
  const float *cos_t, *sin_t;
  void *o, *ws, *y;
  int B, L, dm, H;
  float scale;
};

int launch_f32(const Call& c, cudaStream_t stream, int* launched) {
  const AttnArgsF32 at{static_cast<const float*>(c.x), static_cast<const float*>(c.wqkv),
                       static_cast<const float*>(c.bqkv), c.cos_t, c.sin_t,
                       static_cast<float*>(c.o), static_cast<float*>(c.ws), c.L, c.dm, c.H,
                       c.scale};
  const OutArgsF32 ot{static_cast<const float*>(c.o), static_cast<const float*>(c.wout),
                      static_cast<const float*>(c.bout), static_cast<float*>(c.y), c.B * c.L,
                      c.H * HD, c.dm};
  cudaError_t err;
  fused_layer_attn_f32_kernel<<<dim3(c.H, c.B), THREADS, AttnSmemF32::BYTES, stream>>>(at);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  fused_layer_out_f32_kernel<<<dim3(c.dm / BT, (ot.M + BT - 1) / BT), THREADS,
                               OutSmemF32::BYTES, stream>>>(ot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

int launch_bf16(const Call& c, cudaStream_t stream, int* launched) {
  const int A = c.H * HD, M = c.B * c.L;
  CUtensorMap map_x, map_wqkv, map_o, map_wout;
  const cuuint64_t x_dims[3] = {(cuuint64_t)c.dm, (cuuint64_t)c.L, (cuuint64_t)c.B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)c.dm * 2, (cuuint64_t)c.L * c.dm * 2};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  const cuuint64_t wqkv_dims[2] = {(cuuint64_t)3 * A, (cuuint64_t)c.dm};
  const cuuint64_t wqkv_strides[1] = {(cuuint64_t)3 * A * 2};
  const cuuint64_t o_dims[2] = {(cuuint64_t)A, (cuuint64_t)M};
  const cuuint64_t o_strides[1] = {(cuuint64_t)A * 2};
  const cuuint64_t wout_dims[2] = {(cuuint64_t)c.dm, (cuuint64_t)A};
  const cuuint64_t wout_strides[1] = {(cuuint64_t)c.dm * 2};
  const cuuint32_t w_box[2] = {64, BK}, o_box[2] = {BK, BM};
  if (!wg::encode(&map_x, c.x, 3, x_dims, x_strides, x_box) ||
      !wg::encode(&map_wqkv, c.wqkv, 2, wqkv_dims, wqkv_strides, w_box) ||
      !wg::encode(&map_o, c.o, 2, o_dims, o_strides, o_box) ||
      !wg::encode(&map_wout, c.wout, 2, wout_dims, wout_strides, w_box))
    return (int)cudaErrorInvalidValue;
  const AttnArgs at{static_cast<const bf16*>(c.bqkv), c.cos_t, c.sin_t, static_cast<bf16*>(c.o),
                    static_cast<bf16*>(c.ws), c.L, c.dm, c.H, AttnSmem::kv_region(c.L), c.scale};
  const int tiles_n = (c.dm + OUT_BN - 1) / OUT_BN, tiles = (M + BM - 1) / BM * tiles_n;
  const OutArgs ot{static_cast<const bf16*>(c.bout), static_cast<bf16*>(c.y), M, A, c.dm,
                   tiles_n, tiles};
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaError_t err;
  fused_layer_attn_wgmma_kernel<<<dim3(c.H, c.B), WG_THREADS, AttnSmem::bytes(c.L), stream>>>(
      map_x, map_wqkv, at);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const int blocks = tiles < sms ? tiles : sms;  // persistent: at most one block an SM
  fused_layer_out_wgmma_kernel<<<blocks, WG_THREADS, OutSmem::BYTES, stream>>>(map_o, map_wout,
                                                                              ot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

bool bad_shape(int B, int L, int dm, int H, int head_dim) {
  return head_dim != HD || B <= 0 || L <= 0 || H <= 0 || dm <= 0 || dm % BT || B > 65535 ||
         H > 65535 || (long long)B * L > 65535LL * BT;
}

}  // namespace

// Bytes of the workspace hd_fused_layer needs (0: none). f32: q, k, v of
// every (b, h); bf16: K and V of every (b, h) when they do not fit in
// shared memory (L > 384). dtype 0 = float32, 1 = bfloat16.
extern "C" long long hd_fused_layer_workspace_bytes(int B, int L, int H, int dtype) {
  if (dtype == 0) return (long long)B * H * AttnSmemF32::buf_bytes(L);
  return AttnSmem::in_smem(L) ? 0 : (long long)B * H * AttnSmem::ws_bytes(L);
}

// For each of the two kernels of a call at length L (launch order): the
// dynamic shared memory of a block and the blocks an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t code.
extern "C" int hd_fused_layer_occupancy(int L, int dtype, int* smem_bytes, int* blocks_per_sm) {
  if (L <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_limits(dtype);
  if (err != cudaSuccess) return (int)err;
  const void* k[2] = {(const void*)fused_layer_attn_f32_kernel,
                      (const void*)fused_layer_out_f32_kernel};
  int threads = THREADS;
  smem_bytes[0] = AttnSmemF32::BYTES, smem_bytes[1] = OutSmemF32::BYTES;
  if (dtype == 1) {
    k[0] = (const void*)fused_layer_attn_wgmma_kernel;
    k[1] = (const void*)fused_layer_out_wgmma_kernel;
    threads = WG_THREADS;
    smem_bytes[0] = AttnSmem::bytes(L), smem_bytes[1] = OutSmem::BYTES;
  }
  for (int i = 0; i < 2; ++i)
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm[i], k[i], threads,
                                                            smem_bytes[i])) != cudaSuccess)
      return (int)err;
  return 0;
}

// x [B, L, dm], wqkv [dm, 3*H*64] column-blocked, bqkv [3*H*64], wout
// [H*64, dm], bout [dm], all of one type; cos/sin [L, 32] f32; o [B, L,
// H*64] scratch in that type; ws the workspace above (or null); y [B, L, dm]
// out. bf16 takes x, wqkv, wout and o at 16-byte aligned addresses (TMA).
// Sets *launched to the kernels launched (2 on success) and returns a
// cudaError_t code (0 = launched).
extern "C" int hd_fused_layer(const void* x, const void* wqkv, const void* bqkv,
                              const void* wout, const void* bout, const void* cos_t,
                              const void* sin_t, void* o, void* ws, void* y, int B, int L,
                              int dm, int H, int head_dim, float scale, int dtype, void* stream,
                              int* launched) {
  *launched = 0;
  if (bad_shape(B, L, dm, H, head_dim) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (hd_fused_layer_workspace_bytes(B, L, H, dtype) > 0 && ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (misaligned(x) || misaligned(wqkv) || misaligned(wout) || misaligned(o)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_limits(dtype);
  if (err != cudaSuccess) return (int)err;
  const Call c{x,    wqkv, bqkv, wout, bout, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), o, ws, y, B, L, dm, H, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_f32(c, s, launched) : launch_bf16(c, s, launched);
}
