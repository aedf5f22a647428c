// K8: a whole attention layer, x Wqkv + bqkv -> RoPE attention -> Wout +
// bout, forward only, in two launches.
//
// Replaces tools/fused_layer_probe.py::_fused_layer_kernel (called through
// fused_layer).
//
// What it computes, per batch row b, with T the type of x and of every
// weight (f32 or bf16) and every product of T values accumulated in f32;
// the rounding points are the TPU kernel's:
//   qkv = T(T(x Wqkv) + bqkv)                   Wqkv [dm, 3A] column-blocked:
//                                               q | k | v, head h at h*64
//   per head h: q, k = T(rope(q_h)), T(rope(k_h)) (f32 rotation)
//               o_h  = T(softmax(q k^T * scale) v), P rounded to T
//   y   = T(T(concat_h o_h  Wout) + bout)       Wout [A, dm]
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): operations. At B=64, L=291, dm 768, A 512
// (8 heads), bf16, one call is 43.9 GFLOP of qkv projection, 11.1 of
// attention and 14.6 of out projection: 69.7 GFLOP, 0.070 ms at 989
// TFLOP/s, against ~60 MB of x, y and weights (0.018 ms at 3.35 TB/s).
//
// Design: the TPU kernel held the weights and one batch row in VMEM and did
// the whole layer per row. On Hopper x[b] alone is 447 KB and Wqkv 2.4 MB,
// against 227 KB of shared memory per block, and the out projection sums
// over heads, which blocks cannot share. So two launches:
//   (1) fused_layer_attn_kernel, one block per (h, b): streams 64x64 tiles
//       of x[b] and of head h's three 64-column groups of Wqkv, projects
//       q, k and v 64 rows at a time (WMMA, f32 accumulators), adds the bias
//       and rotates q, k in f32 in the epilogue, and keeps the head's whole
//       [L, 3x64] q, k, v in shared memory (bf16 at L <= 384; at L 291,
//       138 KB of the block's 188 KB). Then K1's online softmax runs over
//       it, each warp on its own 16 query rows with no block barrier, and
//       o_h is written in x's type, the TPU kernel's rounding of each head.
//       Wqkv is re-read for every (b, h) and stays in L2 (2.4 MB).
//   (2) fused_layer_out_kernel: a 64x64-tiled WMMA GEMM of o [B*L, A] by
//       Wout with the rounding and bias in its epilogue.
// qkv never reaches device memory in bf16 at the model's lengths; o does
// (19 MB at B=64). No atomics: every output is summed in a fixed order.
// The f32 variant (the tests' type) does not fit: one head's q, k, v in f32
// at L 291 take 261 KB. It, and bf16 at L > 384, keep them in a workspace
// the wrapper allocates (hd_fused_layer_workspace_bytes says how much), read
// through the same code with generic pointers. f32 products run on plain
// FMA, so they stay exact.

#include "attention_tiles.cuh"

using namespace hd;

namespace {

constexpr int BT = 64;  // rows or columns per tile

template <typename T> struct AttnSmem {
  static constexpr int LDT = ldt<T>();
  static constexpr int TILE = round_up(BT * LDT * (int)sizeof(T), 128);
  static constexpr int FTILE = round_up(BT * LDF * 4, 128);
  // projection: an x tile, three Wqkv tiles, one f32 epilogue tile;
  // attention: S (f32), P (T), O (f32); the two phases share the space
  static constexpr int A_BYTES = 4 * TILE + FTILE;
  static constexpr int B_BYTES = 2 * FTILE + TILE;
  static constexpr int SCRATCH = A_BYTES > B_BYTES ? A_BYTES : B_BYTES;
  // q, k, v of one (b, h), each [round_up(L, 64)][LDT]
  static size_t buf_bytes(int L) { return (size_t)3 * round_up(L, BT) * LDT * sizeof(T); }
  static bool in_smem(int L) { return buf_bytes(L) + SCRATCH <= (size_t)MAX_SMEM; }
  static int bytes(int L) { return SCRATCH + (in_smem(L) ? (int)buf_bytes(L) : 0); }
};

struct AttnArgs {
  const void *x, *wqkv, *bqkv;
  const float *cos_t, *sin_t;  // [L, 32] f32
  void* o;                     // [B, L, A] in x's type
  void* ws;                    // q, k, v per (b, h) when they do not fit, else nullptr
  int L, dm, H;
  float scale;
};

template <typename T>
__device__ __forceinline__ void layer_attn(const AttnArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = AttnSmem<T>;
  constexpr int LDT = SM::LDT, V = Cfg<T>::VEC;
  const int h = blockIdx.x, b = blockIdx.y, H = a.H, L = a.L, dm = a.dm, A = H * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, Lp = round_up(L, BT);
  T* buf = a.ws ? static_cast<T*>(a.ws) + ((size_t)b * H + h) * 3 * Lp * LDT
                : reinterpret_cast<T*>(smem + SM::SCRATCH);

  // -- projection: q, k, v of head h, 64 rows at a time -------------------
  T* sX = reinterpret_cast<T*>(smem);
  float* sE = reinterpret_cast<float*>(smem + 4 * SM::TILE);
  const T* x = static_cast<const T*>(a.x) + (size_t)b * L * dm;
  const T* w = static_cast<const T*>(a.wqkv);
  const T* bias = static_cast<const T*>(a.bqkv);
  for (int r0 = 0; r0 < Lp; r0 += BT) {
    Acc<T> acc[3];
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
        T* sW = reinterpret_cast<T*>(smem + (1 + g) * SM::TILE);
        *reinterpret_cast<uint4*>(sW + r * LDT + c) = *reinterpret_cast<const uint4*>(
            w + (size_t)(k0 + r) * 3 * A + g * A + h * HD + c);
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < 3; ++g)
        acc[g].ab(sX, reinterpret_cast<const T*>(smem + (1 + g) * SM::TILE), warp, lane);
    }
    // epilogue, on the warp's own 16 rows: qkv = T(T(acc) + bias); q and k
    // rotated in f32 and rounded to T; rows >= L stored as zeros (unrolled:
    // acc[g] stays in registers)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      __syncwarp();
      acc[g].store(sE, warp, lane);
      __syncwarp();
      const float b0 = to_f(bias[g * A + h * HD + lane]);
      const float b1 = to_f(bias[g * A + h * HD + lane + D2]);
      T* dst = buf + (size_t)g * Lp * LDT;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r, l = r0 + row;
        T lo = from_f<T>(0.f), hi = from_f<T>(0.f);
        if (l < L) {
          const float e0 = to_f(from_f<T>(to_f(from_f<T>(sE[row * LDF + lane])) + b0));
          const float e1 = to_f(from_f<T>(to_f(from_f<T>(sE[row * LDF + lane + D2])) + b1));
          if (g < 2) {
            const float c = a.cos_t[l * D2 + lane], s = a.sin_t[l * D2 + lane];
            lo = from_f<T>(e0 * c - e1 * s);
            hi = from_f<T>(e0 * s + e1 * c);
          } else {
            lo = from_f<T>(e0);
            hi = from_f<T>(e1);
          }
        }
        dst[(size_t)l * LDT + lane] = lo;
        dst[(size_t)l * LDT + lane + D2] = hi;
      }
    }
  }
  __syncthreads();  // every q, k, v row written; the scratch is free again

  // -- attention over the held q, k, v: K1's online softmax ---------------
  float* sS = reinterpret_cast<float*>(smem);
  T* sP = reinterpret_cast<T*>(smem + SM::FTILE);
  float* sO = reinterpret_cast<float*>(smem + SM::FTILE + SM::TILE);
  const T* bq = buf;
  const T* bk = buf + (size_t)Lp * LDT;
  const T* bv = buf + (size_t)2 * Lp * LDT;
  T* o = static_cast<T*>(a.o) + (size_t)b * L * A + h * HD;
  Acc<T> acc;
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

struct OutArgs {
  const void *o, *wout, *bout;
  void* y;
  int M, A, dm;  // o [M, A], Wout [A, dm], y [M, dm]
};

template <typename T> struct OutSmem {
  static constexpr int TILE = AttnSmem<T>::TILE, FTILE = AttnSmem<T>::FTILE;
  static constexpr int BYTES = 2 * TILE + FTILE;
};

// y[m0 + 64 rows, n0 + 64 columns] = T(T(o Wout) + bout)
template <typename T>
__device__ __forceinline__ void layer_out(const OutArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = OutSmem<T>;
  constexpr int LDT = ldt<T>(), V = Cfg<T>::VEC;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + SM::TILE);
  float* sC = reinterpret_cast<float*>(smem + 2 * SM::TILE);
  const int n0 = blockIdx.x * BT, m0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* o = static_cast<const T*>(a.o);
  const T* w = static_cast<const T*>(a.wout);
  Acc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < a.A; k0 += BT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * (HD / V); idx += THREADS) {
      const int r = idx / (HD / V), c = (idx % (HD / V)) * V, m = m0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < a.M) val = *reinterpret_cast<const uint4*>(o + (size_t)m * a.A + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * LDT + c) = val;
      *reinterpret_cast<uint4*>(sB + r * LDT + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * a.dm + n0 + c);
    }
    __syncthreads();
    acc.ab(sA, sB, warp, lane);
  }
  acc.store(sC, warp, lane);
  __syncwarp();
  const T* bout = static_cast<const T*>(a.bout) + n0;
  const float b0 = to_f(bout[lane]), b1 = to_f(bout[lane + 32]);
  T* y = static_cast<T*>(a.y);
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, m = m0 + row;
    if (m < a.M) {
      T* d = y + (size_t)m * a.dm + n0;
      d[lane] = from_f<T>(to_f(from_f<T>(sC[row * LDF + lane])) + b0);
      d[lane + 32] = from_f<T>(to_f(from_f<T>(sC[row * LDF + lane + 32])) + b1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_layer_attn_kernel(AttnArgs a) {
  layer_attn<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) fused_layer_out_kernel(OutArgs a) {
  layer_out<T>(a);
}

template <typename T>
int launch(const AttnArgs& at, const OutArgs& ot, int B, cudaStream_t stream, int* launched) {
  // set once per instantiation: the port drives one card per process. The
  // attention launch's size depends on L, so its limit is the most a block
  // may have.
  static const cudaError_t a1 = cudaFuncSetAttribute(
      fused_layer_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      fused_layer_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      OutSmem<T>::BYTES);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  cudaError_t err;
  fused_layer_attn_kernel<T>
      <<<dim3(at.H, B), THREADS, AttnSmem<T>::bytes(at.L), stream>>>(at);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  fused_layer_out_kernel<T><<<dim3(ot.dm / BT, (ot.M + BT - 1) / BT), THREADS,
                              OutSmem<T>::BYTES, stream>>>(ot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

bool bad_shape(int B, int L, int dm, int H, int head_dim) {
  return head_dim != HD || B <= 0 || L <= 0 || H <= 0 || dm <= 0 || dm % BT || B > 65535 ||
         H > 65535 || (long long)B * L > 65535LL * BT;
}

}  // namespace

// Bytes of the workspace hd_fused_layer needs for q, k, v (0: they fit in
// shared memory); dtype 0 = float32, 1 = bfloat16.
extern "C" long long hd_fused_layer_workspace_bytes(int B, int L, int H, int dtype) {
  if (dtype == 0)
    return AttnSmem<float>::in_smem(L) ? 0 : (long long)B * H * AttnSmem<float>::buf_bytes(L);
  return AttnSmem<__nv_bfloat16>::in_smem(L)
             ? 0
             : (long long)B * H * AttnSmem<__nv_bfloat16>::buf_bytes(L);
}

// x [B, L, dm], wqkv [dm, 3*H*64] column-blocked, bqkv [3*H*64], wout
// [H*64, dm], bout [dm], all of one type; cos/sin [L, 32] f32; o [B, L,
// H*64] scratch in that type; ws the workspace above (or null); y [B, L, dm]
// out. Sets *launched to the kernels launched (2 on success) and returns a
// cudaError_t code (0 = launched).
extern "C" int hd_fused_layer(const void* x, const void* wqkv, const void* bqkv,
                              const void* wout, const void* bout, const void* cos_t,
                              const void* sin_t, void* o, void* ws, void* y, int B, int L,
                              int dm, int H, int head_dim, float scale, int dtype, void* stream,
                              int* launched) {
  *launched = 0;
  if (bad_shape(B, L, dm, H, head_dim)) return (int)cudaErrorInvalidValue;
  const AttnArgs at{x, wqkv, bqkv, static_cast<const float*>(cos_t),
                    static_cast<const float*>(sin_t), o, ws, L, dm, H, scale};
  const OutArgs ot{o, wout, bout, y, B * L, H * HD, dm};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!AttnSmem<float>::in_smem(L) && ws == nullptr) return (int)cudaErrorInvalidValue;
    return launch<float>(at, ot, B, s, launched);
  }
  if (dtype == 1) {
    if (!AttnSmem<__nv_bfloat16>::in_smem(L) && ws == nullptr) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(at, ot, B, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}
