// K1, K5 and K7: one hand-written attention forward, instantiated three
// times for three layouts.
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
//   q, k = rope(q), rope(k)                      rotate-half, in f32, rounded
//                                                to the input type (K1, K5;
//                                                K7 takes q, k as they are)
//   S    = (q k^T in the input type, f32 accumulation) * scale
//   P    = softmax(S) over all L keys (no mask: the pad token is a token)
//   out  = P v, P rounded to v's type, f32 accumulation
// K7's TPU kernel casts q and k to f32 before the product; a product of two
// bf16 values is exact in f32, so bf16 WMMA with f32 accumulation computes
// the same sums.
//
// Layout: each operand is reached through a base pointer and a Layout
// (batch stride, row stride, per-head offset); q, k and v share one, out has
// its own. K1 points q, k, v at columns 0, 64, 128 of the merged qkv.
//
// What bounds it on an H100 (data-sheet peaks of the NVIDIA H100 80GB HBM3 at
// 700 W): bytes. At B=64, L=291, bf16 one K1 call reads
// the 57 MB qkv block and writes 19 MB, about 23 us at 3.35 TB/s, against
// about 11 GFLOP (11 us) of tensor-core work; K5 and K7 move the same bytes.
//
// Design: the TPU kernel held one batch row's whole [L, L] score block in
// VMEM. An f32 [291, 291] block is 339 KB, more than a block's 227 KB of
// shared memory, so here one block takes (b, h, 64 queries) and walks the
// keys in tiles of 64 with an online softmax (running max and sum per row;
// the output accumulator is rescaled in shared memory). Keys >= L are
// masked to -inf and rows >= L are never stored, so any L works. Tiles are
// read with 16-byte loads, and the next key/value tile's loads are issued
// into registers before the current tile is computed, so their latency
// overlaps the tensor-core work. In the softmax each lane owns two columns
// of every row (no shared-memory bank conflicts). bf16 products run on WMMA
// 16x16x16 fragments with f32 accumulators; f32 inputs (the tests'
// reference type) take a plain FMA path so they stay exact. Each query tile
// reads its head's K/V again; the repeats hit L2. The three instantiations
// have their own kernel names, so a profiler tells them apart.

#include "attention_tiles.cuh"

using namespace hd;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile

template <typename T>
struct Smem {
  static constexpr int LDT = ldt<T>();  // q/k/v and probability tile row stride
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + BQ * LDT * (int)sizeof(T), 128);
  static constexpr int V = round_up(K + BKV * LDT * (int)sizeof(T), 128);
  static constexpr int P = round_up(V + BKV * LDT * (int)sizeof(T), 128);
  static constexpr int S = round_up(P + BQ * LDT * (int)sizeof(T), 128);
  static constexpr int O = round_up(S + BQ * LDF * 4, 128);
  static constexpr int BYTES = round_up(O + BQ * LDF * 4, 128);
};

// One 64-row tile of q or k (rotated when ROPE) and v, held in registers
// between the global loads and the shared-memory stores. Rotated item: one
// row's columns [c, c + V) and [c + 32, c + 32 + V) with their cos/sin.
template <typename T, bool ROPE> struct TileRegs {
  static constexpr int V = Cfg<T>::VEC;
  static constexpr int NR = 64 * (D2 / V) / THREADS;  // rotated items per thread
  static constexpr int NV = 64 * (HD / V) / THREADS;  // plain vectors per thread
  Pack<T> x0[NR], x1[NR], v[NV];
  float cs[NR][V], sn[NR][V];

  // rows [row0, row0 + 64) of one (b, h) slice: `src` is its q or k row 0,
  // `vsrc` its v row 0 (nullptr: no v); rows are `row_stride` apart
  __device__ void load(const T* src, const T* vsrc, const float* cos_t, const float* sin_t,
                       int row0, int L, int row_stride) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V, l = row0 + r;
      x0[i].u = x1[i].u = make_uint4(0, 0, 0, 0);
      if (ROPE) {
#pragma unroll
        for (int e = 0; e < V; ++e) cs[i][e] = sn[i][e] = 0.f;
      }
      if (l < L) {
        const T* p = src + (size_t)l * row_stride + c0;
        x0[i].u = *reinterpret_cast<const uint4*>(p);
        x1[i].u = *reinterpret_cast<const uint4*>(p + D2);
        if (ROPE) {
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 cc = *reinterpret_cast<const float4*>(cos_t + l * D2 + c0 + e);
            const float4 ss = *reinterpret_cast<const float4*>(sin_t + l * D2 + c0 + e);
            cs[i][e] = cc.x, cs[i][e + 1] = cc.y, cs[i][e + 2] = cc.z, cs[i][e + 3] = cc.w;
            sn[i][e] = ss.x, sn[i][e + 1] = ss.y, sn[i][e + 2] = ss.z, sn[i][e + 3] = ss.w;
          }
        }
      }
    }
    if (vsrc == nullptr) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V, l = row0 + r;
      v[i].u = make_uint4(0, 0, 0, 0);
      if (l < L) v[i].u = *reinterpret_cast<const uint4*>(vsrc + (size_t)l * row_stride + c0);
    }
  }

  // rotate in f32 and round to T, (a, b) -> (a cos - b sin, a sin + b cos),
  // or (without ROPE) store as loaded
  __device__ void store(T* s_rot, T* s_v) {
    constexpr int LDT = Smem<T>::LDT;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (D2 / V), c0 = (idx % (D2 / V)) * V;
      Pack<T> lo = x0[i], hi = x1[i];
      if (ROPE) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float x = to_f(x0[i][e]), y = to_f(x1[i][e]);
          lo[e] = from_f<T>(x * cs[i][e] - y * sn[i][e]);
          hi[e] = from_f<T>(x * sn[i][e] + y * cs[i][e]);
        }
      }
      *reinterpret_cast<uint4*>(s_rot + r * LDT + c0) = lo.u;
      *reinterpret_cast<uint4*>(s_rot + r * LDT + c0 + D2) = hi.u;
    }
    if (s_v == nullptr) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (HD / V), c0 = (idx % (HD / V)) * V;
      *reinterpret_cast<uint4*>(s_v + r * LDT + c0) = v[i].u;
    }
  }
};

struct Args {
  const void *q, *k, *v;
  void* out;
  Layout in, o;             // q, k, v share `in`
  const float *cos_t, *sin_t;  // [L, 32] f32 (unused without RoPE)
  int L;
  float scale;
};

template <typename T, bool ROPE>
__device__ __forceinline__ void attention_fwd(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<T>;
  T* sQ = reinterpret_cast<T*>(smem + SM::Q);
  T* sK = reinterpret_cast<T*>(smem + SM::K);
  T* sV = reinterpret_cast<T*>(smem + SM::V);
  T* sP = reinterpret_cast<T*>(smem + SM::P);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sO = reinterpret_cast<float*>(smem + SM::O);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, L = a.L;
  const T* q = static_cast<const T*>(a.q) + a.in.at(b, h);
  const T* k = static_cast<const T*>(a.k) + a.in.at(b, h);
  const T* v = static_cast<const T*>(a.v) + a.in.at(b, h);

  TileRegs<T, ROPE> regs;
  regs.load(q, nullptr, a.cos_t, a.sin_t, q0, L, a.in.row);
  regs.store(sQ, nullptr);
  regs.load(k, v, a.cos_t, a.sin_t, 0, L, a.in.row);
  for (int idx = threadIdx.x; idx < BQ * LDF; idx += THREADS) sO[idx] = 0.f;

  // every lane of a warp tracks the running max / sum of the warp's 16 rows
  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f;

  Acc<T> acc;
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
  store_rows(static_cast<T*>(a.out) + a.o.at(b, h), a.o.row, sO, l_run, q0, L, warp, lane);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_qkv_kernel(Args a) {
  attention_fwd<T, true>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) rope_attention_sep_fwd_kernel(Args a) {
  attention_fwd<T, true>(a);
}
template <typename T>
__global__ void __launch_bounds__(THREADS) plain_attention_kernel(Args a) {
  attention_fwd<T, false>(a);
}

template <typename T, void (*KERNEL)(Args)>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  // set once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.L + BQ - 1) / BQ, H, B);
  KERNEL<<<grid, THREADS, Smem<T>::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int L, int H, int head_dim) {
  return head_dim != HD || B <= 0 || L <= 0 || H <= 0 || H > 65535 || B > 65535;
}

}  // namespace

// qkv [B, L, H*3*64] head-major, cos/sin [L, 32] f32, out [B, L, H*64];
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int hd_rope_attention_qkv(const void* qkv, const void* cos_t, const void* sin_t,
                                     void* out, int B, int L, int H, int head_dim,
                                     float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  const Args a{base, base + HD * es, base + 2 * HD * es, out,
               Layout{L * 3 * H * HD, 3 * H * HD, 3 * HD}, Layout{L * H * HD, H * HD, HD},
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, rope_attention_qkv_kernel<float>>(a, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_qkv_kernel<__nv_bfloat16>>(a, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out [B, L, H*64] (K5), cos/sin [L, 32] f32; dtype as above.
extern "C" int hd_rope_attention(const void* q, const void* k, const void* v,
                                 const void* cos_t, const void* sin_t, void* out, int B, int L,
                                 int H, int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const Layout lay{L * H * HD, H * HD, HD};
  const Args a{q, k, v, out, lay, lay, static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, rope_attention_sep_fwd_kernel<float>>(a, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, rope_attention_sep_fwd_kernel<__nv_bfloat16>>(a, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// K7: q, k, v with element (b, h, l, c) at b*in_batch + h*in_head + l*in_row + c,
// out likewise with the out_* strides; no RoPE; dtype as above.
extern "C" int hd_attention(const void* q, const void* k, const void* v, void* out, int B,
                            int L, int H, int head_dim, int in_batch, int in_row, int in_head,
                            int out_batch, int out_row, int out_head, float scale, int dtype,
                            void* stream) {
  if (bad_shape(B, L, H, head_dim)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, Layout{in_batch, in_row, in_head},
               Layout{out_batch, out_row, out_head}, nullptr, nullptr, L, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, plain_attention_kernel<float>>(a, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, plain_attention_kernel<__nv_bfloat16>>(a, B, H, s);
  return (int)cudaErrorInvalidValue;
}
