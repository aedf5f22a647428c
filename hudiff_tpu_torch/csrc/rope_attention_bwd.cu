// K3 and K6: backward of the fused rotate-half RoPE attention, as two
// launches, instantiated for two layouts.
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
//   qh, kh = T(rope(q)), T(rope(k))            rotate-half, in f32
//   P      = softmax(qh kh^T * scale)           f32, over all L keys
//   dv     = T(P)^T dO
//   dP     = dO v^T ; delta = rowsum(dP o P)
//   dS     = T(P o (dP - delta))
//   dq     = rope^T(dS kh * scale), dk = rope^T(dS^T qh * scale), in f32
//   dq, dk, dv rounded to T
// q, k, v and dq, dk, dv share one Layout (batch stride, row stride,
// per-head offset); dO is [B, L, H*64] in both.
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): at B=128, L=291, bf16 one call reads q, k, v
// and dO (143 MB) and writes dq, dk, dv (114 MB), 0.080 ms at 3.35 TB/s,
// against five 2*L^2*D products per (row, head), 55.5 GFLOP or 0.056 ms at
// 989 TFLOP/s: bytes, narrowly.
//
// Design: the TPU kernel held a row's whole [L, L] score block per head in
// VMEM; an f32 [291, 291] block is 339 KB, more than a block's 227 KB of
// shared memory, and dK, dV are sums over all query rows, which Hopper
// blocks cannot carry across a grid. So two passes, with no atomics and the
// same bits every run:
//   (a) the dq kernel: one block per (b, h, 64 queries) walks the keys in
//       64-wide tiles twice. The first walk keeps the running max m, sum l
//       and sum of exp(s - m) * dP per row (online, as K1 does), so delta =
//       that sum / l; the second recomputes P exactly, forms dS and
//       accumulates dQ = dS K. It writes dq and the row statistics
//       (m, l, delta) [3][B, H, L] f32.
//   (b) the dkv kernel: one block per (b, h, 64 keys) walks the query
//       tiles, recomputes P from the saved statistics and accumulates
//       dV = P^T dO and dK = dS^T Q in registers.
// Keys >= L are masked, rows >= L never written. bf16 products run on WMMA
// 16x16x16 fragments with f32 accumulators (the transposed products load a
// column-major A fragment); f32 inputs take a plain FMA path so they stay
// exact. Tiles are staged synchronously; each pass recomputes S (and dP)
// instead of keeping them, so the block's shared memory stays at 91 KB in
// bf16. K3's kernels are rope_attention_bwd_{dq,dkv}_kernel, K6's
// rope_attention_sep_bwd_{dq,dkv}_kernel: one body, two names.

#include "attention_tiles.cuh"

using namespace hd;

namespace {

constexpr int BT = 64;       // queries or keys per tile

// Shared memory: six T tiles [64][LDT] and two f32 tiles [64][LDF], plus
// three per-row statistics of a query tile.
template <typename T> struct Smem {
  static constexpr int LDT = ldt<T>();
  static constexpr int TILE = round_up(BT * LDT * (int)sizeof(T), 128);
  static constexpr int FTILE = round_up(BT * LDF * 4, 128);
  static constexpr int T0 = 0;                       // 6 T tiles
  static constexpr int F0 = 6 * TILE;                // 2 f32 tiles
  static constexpr int ST = F0 + 2 * FTILE;          // 3 x 64 f32
  static constexpr int BYTES = ST + 3 * BT * 4;
};

// rows [row0, row0 + 64) of one (b, h) slice of q or k (`src` its row 0,
// rows `row_stride` apart), rotated in f32 and rounded to T; zero rows past L
template <typename T>
__device__ void load_rot(T* dst, const T* src, const float* cos_t, const float* sin_t,
                         int row0, int L, int row_stride) {
  constexpr int V = Cfg<T>::VEC, LDT = Smem<T>::LDT;
  for (int idx = threadIdx.x; idx < BT * (D2 / V); idx += THREADS) {
    const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V, l = row0 + r;
    Pack<T> lo, hi;
    lo.u = hi.u = make_uint4(0, 0, 0, 0);
    if (l < L) {
      const T* p = src + (size_t)l * row_stride + c0;
      Pack<T> x0, x1;
      x0.u = *reinterpret_cast<const uint4*>(p);
      x1.u = *reinterpret_cast<const uint4*>(p + D2);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = cos_t[l * D2 + c0 + e], s = sin_t[l * D2 + c0 + e];
        const float x = to_f(x0[e]), y = to_f(x1[e]);
        lo[e] = from_f<T>(x * c - y * s);
        hi[e] = from_f<T>(x * s + y * c);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c0) = lo.u;
    *reinterpret_cast<uint4*>(dst + r * LDT + c0 + D2) = hi.u;
  }
}

// rows [row0, row0 + 64) of one (b, h) slice as they are
template <typename T>
__device__ void load_plain(T* dst, const T* src, int row0, int L, int row_stride) {
  constexpr int V = Cfg<T>::VEC, LDT = Smem<T>::LDT;
  for (int idx = threadIdx.x; idx < BT * (HD / V); idx += THREADS) {
    const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V, l = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (l < L) v = *reinterpret_cast<const uint4*>(src + (size_t)l * row_stride + c0);
    *reinterpret_cast<uint4*>(dst + r * LDT + c0) = v;
  }
}

// One output row's 64 columns from an f32 tile row: rotated back by the
// inverse RoPE after scaling (rot = true), or as they are.
template <typename T>
__device__ void write_row(T* dst, const float* row, const float* cos_t, const float* sin_t,
                          int l, float scale, bool rot, int lane) {
  if (rot) {
    const float a = row[lane] * scale, b = row[lane + D2] * scale;
    const float c = cos_t[l * D2 + lane], s = sin_t[l * D2 + lane];
    dst[lane] = from_f<T>(a * c + b * s);
    dst[lane + D2] = from_f<T>(b * c - a * s);
  } else {
    dst[lane] = from_f<T>(row[lane]);
    dst[lane + D2] = from_f<T>(row[lane + D2]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float* stats;             // [3][B, H, L] f32 scratch
  Layout in;                // q, k, v, dq, dk, dv
  const float *cos_t, *sin_t;
  int L;
  float scale;
};

template <typename T>
__device__ __forceinline__ void bwd_dq(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  constexpr int LDT = SM::LDT;
  T* sQ = reinterpret_cast<T*>(smem + 0 * SM::TILE);
  T* sDO = reinterpret_cast<T*>(smem + 1 * SM::TILE);
  T* sK = reinterpret_cast<T*>(smem + 2 * SM::TILE);
  T* sV = reinterpret_cast<T*>(smem + 3 * SM::TILE);
  T* sDS = reinterpret_cast<T*>(smem + 4 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const float scale = a.scale;
  const size_t bh = a.in.at(b, h);
  const T* q = static_cast<const T*>(a.q) + bh;
  const T* k = static_cast<const T*>(a.k) + bh;
  const T* v = static_cast<const T*>(a.v) + bh;
  const T* dout = static_cast<const T*>(a.dout) + ((size_t)b * L * H + h) * HD;
  float* stats = a.stats;
  const size_t bhl = (size_t)gridDim.z * H * L, srow = ((size_t)b * H + h) * L;

  load_rot(sQ, q, a.cos_t, a.sin_t, q0, L, rs);
  load_plain(sDO, dout, q0, L, H * HD);

  // every lane of a warp tracks its 16 rows' running max, sum and
  // sum of exp(s - m) * dP
  float m_run[16], l_run[16], d_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f, d_run[r] = 0.f;

  Acc<T> acc;
  for (int pass = 0; pass < 2; ++pass) {
    Acc<T> dq;
    dq.zero();
    for (int k0 = 0; k0 < L; k0 += BT) {
      __syncthreads();  // previous tile fully read
      load_rot(sK, k, a.cos_t, a.sin_t, k0, L, rs);
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
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r;
        const float s0 = ok0 ? sS[row * LDF + lane] * scale : -INFINITY;
        const float s1 = ok1 ? sS[row * LDF + lane + 32] * scale : -INFINITY;
        const float dp0 = sDP[row * LDF + lane], dp1 = sDP[row * LDF + lane + 32];
        if (pass == 0) {
          const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
          const float alpha = expf(m_run[r] - m_new);
          const float e0 = ok0 ? expf(s0 - m_new) : 0.f;
          const float e1 = ok1 ? expf(s1 - m_new) : 0.f;
          l_run[r] = l_run[r] * alpha + warp_sum(e0 + e1);
          d_run[r] = d_run[r] * alpha + warp_sum(e0 * dp0 + e1 * dp1);
          m_run[r] = m_new;
        } else {
          const float p0 = ok0 ? expf(s0 - m_run[r]) / l_run[r] : 0.f;
          const float p1 = ok1 ? expf(s1 - m_run[r]) / l_run[r] : 0.f;
          sDS[row * LDT + lane] = from_f<T>(p0 * (dp0 - d_run[r]));
          sDS[row * LDT + lane + 32] = from_f<T>(p1 * (dp1 - d_run[r]));
        }
      }
      __syncwarp();
      if (pass == 1) dq.ab(sDS, sK, warp, lane);  // the warp's own dS rows, every key
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        d_run[r] /= l_run[r];  // delta = rowsum(dP o P)
        const int l = q0 + warp * 16 + r;
        if (lane == 0 && l < L) {
          stats[srow + l] = m_run[r];
          stats[bhl + srow + l] = l_run[r];
          stats[2 * bhl + srow + l] = d_run[r];
        }
      }
    } else {
      __syncwarp();
      dq.store(sS, warp, lane);  // the warp's own rows of sS
      __syncwarp();
      T* dst = static_cast<T*>(a.dq) + bh;
#pragma unroll 1
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r, l = q0 + row;
        if (l < L)
          write_row(dst + (size_t)l * rs, sS + row * LDF, a.cos_t, a.sin_t, l, scale, true,
                    lane);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void bwd_dkv(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  constexpr int LDT = SM::LDT;
  T* sK = reinterpret_cast<T*>(smem + 0 * SM::TILE);
  T* sV = reinterpret_cast<T*>(smem + 1 * SM::TILE);
  T* sQ = reinterpret_cast<T*>(smem + 2 * SM::TILE);
  T* sDO = reinterpret_cast<T*>(smem + 3 * SM::TILE);
  T* sP = reinterpret_cast<T*>(smem + 4 * SM::TILE);
  T* sDS = reinterpret_cast<T*>(smem + 5 * SM::TILE);
  float* sS = reinterpret_cast<float*>(smem + SM::F0);
  float* sDP = reinterpret_cast<float*>(smem + SM::F0 + SM::FTILE);
  float* sM = reinterpret_cast<float*>(smem + SM::ST);
  float* sL = sM + BT;
  float* sD = sL + BT;

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rs = a.in.row;
  const float scale = a.scale;
  const size_t bh = a.in.at(b, h);
  const T* q = static_cast<const T*>(a.q) + bh;
  const T* k = static_cast<const T*>(a.k) + bh;
  const T* v = static_cast<const T*>(a.v) + bh;
  const T* dout = static_cast<const T*>(a.dout) + ((size_t)b * L * H + h) * HD;
  const float* stats = a.stats;
  const size_t bhl = (size_t)gridDim.z * H * L, srow = ((size_t)b * H + h) * L;

  load_rot(sK, k, a.cos_t, a.sin_t, k0, L, rs);
  load_plain(sV, v, k0, L, rs);

  Acc<T> dk, dv, acc;
  dk.zero();
  dv.zero();
  const bool ok0 = k0 + lane < L, ok1 = k0 + lane + 32 < L;
  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // previous query tile fully read
    load_rot(sQ, q, a.cos_t, a.sin_t, q0, L, rs);
    load_plain(sDO, dout, q0, L, H * HD);
    for (int i = threadIdx.x; i < BT; i += THREADS) {
      const bool ok = q0 + i < L;
      sM[i] = ok ? stats[srow + q0 + i] : 0.f;
      sL[i] = ok ? stats[bhl + srow + q0 + i] : 1.f;
      sD[i] = ok ? stats[2 * bhl + srow + q0 + i] : 0.f;
    }
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
      const float m = sM[row], l = sL[row], delta = sD[row];
      const float p0 = okq && ok0 ? expf(sS[row * LDF + lane] * scale - m) / l : 0.f;
      const float p1 = okq && ok1 ? expf(sS[row * LDF + lane + 32] * scale - m) / l : 0.f;
      sP[row * LDT + lane] = from_f<T>(p0);
      sP[row * LDT + lane + 32] = from_f<T>(p1);
      sDS[row * LDT + lane] = from_f<T>(p0 * (sDP[row * LDF + lane] - delta));
      sDS[row * LDT + lane + 32] = from_f<T>(p1 * (sDP[row * LDF + lane + 32] - delta));
    }
    __syncthreads();  // the products below read every query row
    dv.atb(sP, sDO, warp, lane);   // dV[key][d] += sum_q P[q][key] dO[q][d]
    dk.atb(sDS, sQ, warp, lane);   // dK[key][d] += sum_q dS[q][key] Q[q][d]
  }
  __syncthreads();
  dv.store(sS, warp, lane);
  dk.store(sDP, warp, lane);
  __syncwarp();
  T* dk_out = static_cast<T*>(a.dk) + bh;
  T* dv_out = static_cast<T*>(a.dv) + bh;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_dq_kernel(Args a) {
  bwd_dq<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_dkv_kernel(Args a) {
  bwd_dkv<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_bwd_dq_kernel(Args a) {
  bwd_dq<T>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_bwd_dkv_kernel(Args a) {
  bwd_dkv<T>(a);
}

template <typename T, void (*DQ)(Args), void (*DKV)(Args)>
int launch(const Args& a, int B, int H, cudaStream_t stream, int* launched) {
  constexpr int bytes = Smem<T>::BYTES;
  // set once per instantiation: the port drives one card per process
  static const cudaError_t a1 =
      cudaFuncSetAttribute(DQ, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t a2 =
      cudaFuncSetAttribute(DKV, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  const dim3 grid((a.L + BT - 1) / BT, H, B);
  cudaError_t err;
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
// qkv's type, dqkv [B, L, H*3*64] out, stats [3, B, H, L] f32 scratch;
// dtype 0 = float32, 1 = bfloat16. Sets *launched to the number of kernels
// launched (2 on success) and returns a cudaError_t code (0 = launched).
extern "C" int hd_rope_attention_qkv_bwd(const void* qkv, const void* cos_t,
                                         const void* sin_t, const void* dout, void* dqkv,
                                         void* stats, int B, int L, int H, int head_dim,
                                         float scale, int dtype, void* stream, int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const char* in = static_cast<const char*>(qkv);
  char* g = static_cast<char*>(dqkv);
  const Args a{in, in + HD * es, in + 2 * HD * es, dout, g, g + HD * es, g + 2 * HD * es,
               static_cast<float*>(stats), Layout{L * 3 * H * HD, 3 * H * HD, 3 * HD},
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, rope_attention_bwd_dq_kernel<float>,
                  rope_attention_bwd_dkv_kernel<float>>(a, B, H, s, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_bwd_dq_kernel<__nv_bfloat16>,
                  rope_attention_bwd_dkv_kernel<__nv_bfloat16>>(a, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

// K6: q, k, v, dout [B, L, H*64], dq, dk, dv [B, L, H*64] out, stats and
// the rest as above.
extern "C" int hd_rope_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* cos_t, const void* sin_t, const void* dout,
                                     void* dq, void* dk, void* dv, void* stats, int B, int L,
                                     int H, int head_dim, float scale, int dtype, void* stream,
                                     int* launched) {
  *launched = 0;
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, dq, dk, dv, static_cast<float*>(stats),
               Layout{L * H * HD, H * HD, HD}, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, rope_attention_sep_bwd_dq_kernel<float>,
                  rope_attention_sep_bwd_dkv_kernel<float>>(a, B, H, s, launched);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_sep_bwd_dq_kernel<__nv_bfloat16>,
                  rope_attention_sep_bwd_dkv_kernel<__nv_bfloat16>>(a, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}
