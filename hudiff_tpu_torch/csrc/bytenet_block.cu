// K2: the ByteNet residual block forward, as six launches (three GEMMs and
// three LayerNorm row passes).
//
// Replaces hudiff_tpu/ops/pallas_bytenet.py::_fwd_kernel (called through
// _pallas_fwd / bytenet_block_fused).
//
// What it computes, with LN = f32 LayerNorm (eps 1e-6, var = E[x^2] - E[x]^2),
// act = ReLU or exact-erf GELU, and cd = the activation type:
//   p = cd(act(LN1 x) W1 + c1)
//   q = cd(dilconv(act(LN2 p)) + cc)      zero outside the chain's [0, L)
//   y = cd(x + act(LN3 q) W2 + c2)
// Matmul inputs are in cd, accumulation in f32.
//
// What bounds it on an H100: operations. For the 768/384 dual-tower block at
// B=64, L=152 one forward is about 31.5 GFLOP (32 us at 989 TFLOP/s bf16)
// against about 30 MB of activations (9 us at 3.35 TB/s).
//
// Design: the TPU kernel held a whole [TB, L, 768] tile in VMEM; a bf16
// [152, 768] tile is 233 KB, over a block's 227 KB, and the dilation-32 conv
// reaches +-96 rows. So the block is split over the flattened [B*L, *] rows:
// (bytenet_ln_act_kernel for the row passes, bytenet_gemm_kernel for the GEMMs)
//   1. ln_act_rows:  a = cd(act(LN1 x)), one warp per row
//   2. gemm<A_ROWS>: p = cd(a W1^T + c1)
//   3. ln_act_rows:  bb = cd(act(LN2 p))
//   4. gemm<A_CONV>: q = cd(im2col(bb) Wc^T + cc) with Wc laid out
//                    [out][K][in], i.e. a [H, K*H] matrix; A's row m, chunk
//                    of tap t is row m + (t - (K-1)/2) * dil of the same chain,
//                    or zero outside it, so the heavy/light boundary is never
//                    crossed
//   5. ln_act_rows:  e = cd(act(LN3 q))
//   6. gemm<A_ROWS>: y = cd(x + e W2^T + c2)
// Every GEMM uses 64x64 output tiles over 4 warps (16 antibody rows still
// give 200+ blocks) and a 4-stage cp.async pipeline of 16-byte copies (rows
// outside the chain are zero-filled by the copy itself), so three chunks'
// loads are in flight while the tensor cores work on the fourth. bf16
// products run on WMMA 16x16x16 fragments with f32 accumulators; f32 inputs
// take a plain FMA path so they stay exact. The extra traffic is a, p/q and
// bb/e ([B*L, D] + 2 x [B*L, H] in cd), which stay in L2 at the main path's
// sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth per staged chunk
constexpr int WARPS = 4;      // 2 x 2 warps, each owns a 32 x 32 sub-tile
constexpr int THREADS = WARPS * 32;
constexpr int LDC = BN + 4;   // f32 output tile row stride
constexpr int ROWS_PER_BLOCK = 8;  // ln_act_rows: one warp per row
constexpr int STAGES = 4;     // cp.async pipeline depth
constexpr float LN_EPS = 1e-6f;
enum { A_ROWS = 0, A_CONV = 1 };

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int PAD = 4, VEC = 4; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8, VEC = 8; };
template <typename T> constexpr int LDK = BK + Cfg<T>::PAD;  // A/B tile row stride
template <typename T> constexpr int TILE = BM * LDK<T>;      // elements per A or B tile
template <typename T> constexpr int PER_ROW = BK / Cfg<T>::VEC;
template <typename T> constexpr int PER_THREAD = BM * PER_ROW<T> / THREADS;  // vectors

// 16 bytes of T, loaded and stored as one vector
template <typename T> struct Pack {
  uint4 u;
  __device__ __forceinline__ T& operator[](int i) { return reinterpret_cast<T*>(&u)[i]; }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float act_fn(float u, int gelu) {
  return gelu ? 0.5f * u * (1.f + erff(u * 0.70710678118654752f)) : fmaxf(u, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> __device__ __forceinline__ Pack<T> load16(const T* p) {
  Pack<T> r;
  r.u = *reinterpret_cast<const uint4*>(p);
  return r;
}

// Row statistics (mean, 1/sigma) of an f32 LayerNorm over n values.
template <typename T>
__device__ void row_stats(const T* row, int n, int lane, float& mean, float& inv) {
  constexpr int V = Cfg<T>::VEC;
  float s = 0.f, s2 = 0.f;
  for (int c = lane * V; c < n; c += 32 * V) {
    Pack<T> p = load16(row + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f(p[e]);
      s += v;
      s2 += v * v;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mean = s / n;
  inv = rsqrtf(fmaxf(s2 / n - mean * mean, 0.f) + LN_EPS);
}

// One block's 64 x 64 f32 accumulator; warp w owns rows (w/2)*32, cols (w%2)*32.
// A is [BM][LDK] row-major in shared memory, B is n-major [BN][LDK].
template <typename T> struct Tile;

template <> struct Tile<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int LD = LDK<bf16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void mma(const bf16* sA, const bf16* sB, int warp, int) {
    const int r0 = (warp / 2) * 32, c0 = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sA + (r0 + 16 * i) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sB + (c0 + 16 * j) * LD + kk, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* sC, int warp, int) {
    const int r0 = (warp / 2) * 32, c0 = (warp % 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (r0 + 16 * i) * LDC + c0 + 16 * j, acc[i][j], LDC,
                                wmma::mem_row_major);
  }
};

// f32: lane owns 4 rows x 8 columns of its warp's 32 x 32 sub-tile.
template <> struct Tile<float> {
  static constexpr int LD = LDK<float>;
  float acc[4][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void mma(const float* sA, const float* sB, int warp, int lane) {
    const int r0 = (warp / 2) * 32 + (lane / 4) * 4, c0 = (warp % 2) * 32 + (lane % 4) * 8;
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(r0 + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[(c0 + j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* sC, int warp, int lane) {
    const int r0 = (warp / 2) * 32 + (lane / 4) * 4, c0 = (warp % 2) * 32 + (lane % 4) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sC[(r0 + i) * LDC + c0 + j] = acc[i][j];
  }
};

// 16-byte global -> shared copy in flight until cp_async_wait; src_bytes 0
// fills the 16 bytes with zeros (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> struct GemmArgs {
  const T* a;          // A_ROWS: [M, Kd]; A_CONV: bb [M, H]
  const T* w;          // [N, Kd] row-major (A_CONV: [H, K*H], i.e. [out][K][in])
  const float* bias;   // [N]
  const T* res;        // residual [M, N] or nullptr
  T* out;              // [M, N]
  int M, Kd, N;
  int L, H, K, dil;    // A_CONV: chain length, channels, taps, dilation
};

template <typename T> __host__ __device__ constexpr int gemm_smem_bytes() {
  return STAGES * 2 * TILE<T> * (int)sizeof(T);  // stages x (A, B); reused for the f32 C tile
}

// out = cd([res +] A W^T + bias) for one 64 x 64 tile, with A as AMODE says.
template <typename T, int AMODE>
__global__ void __launch_bounds__(THREADS) bytenet_gemm_kernel(GemmArgs<T> p) {
  constexpr int V = Cfg<T>::VEC, PR = PER_ROW<T>, PT = PER_THREAD<T>;
  static_assert(BM * LDC * 4 <= gemm_smem_bytes<T>(), "C tile must fit in the stages");
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);  // [STAGES][BM][LDK]
  T* sB = sA + STAGES * TILE<T>;       // [STAGES][BN][LDK]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nchunks = p.Kd / BK;

  // issue the copies of chunk c into stage s
  auto fetch = [&](int c, int s) {
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int idx = threadIdx.x + i * THREADS, r = idx / PR, v = idx % PR;
      const int m = m0 + r;
      const T* src = p.a;
      bool ok = false;
      if (AMODE == A_ROWS) {
        ok = m < p.M;
        if (ok) src = p.a + (size_t)m * p.Kd + c * BK + v * V;
      } else {
        const int per_tap = p.H / BK, t = c / per_tap;
        const int shift = (t - (p.K - 1) / 2) * p.dil;
        const int ls = m % p.L + shift;
        ok = m < p.M && ls >= 0 && ls < p.L;
        if (ok) src = p.a + (size_t)(m + shift) * p.H + (c % per_tap) * BK + v * V;
      }
      cp_async16(sA + s * TILE<T> + r * LDK<T> + v * V, src, ok);
      const bool okb = n0 + r < p.N;
      cp_async16(sB + s * TILE<T> + r * LDK<T> + v * V,
                 okb ? p.w + (size_t)(n0 + r) * p.Kd + c * BK + v * V : p.w, okb);
    }
  };

  Tile<T> tile;
  tile.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (for this thread) ...
    __syncthreads();              // ... and for every thread; stage (c-1) is free
    const int next = c + STAGES - 1;
    if (next < nchunks) fetch(next, next % STAGES);
    cp_async_commit();
    const int s = c % STAGES;
    tile.mma(sA + s * TILE<T>, sB + s * TILE<T>, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  tile.store(sC, warp, lane);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN, m = m0 + r, col = n0 + n;
    if (m < p.M && col < p.N) {
      float v = sC[r * LDC + n] + p.bias[col];
      if (p.res) v = to_f(p.res[(size_t)m * p.N + col]) + v;
      p.out[(size_t)m * p.N + col] = from_f<T>(v);
    }
  }
}

// out = cd(act(LN(in))) row by row, one warp per row.
template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
bytenet_ln_act_kernel(const T* __restrict__ in, const float* __restrict__ g,
                   const float* __restrict__ beta, T* __restrict__ out, int M, int N,
                   int gelu) {
  constexpr int V = Cfg<T>::VEC;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (m >= M) return;
  const T* row = in + (size_t)m * N;
  float mean, inv;
  row_stats(row, N, lane, mean, inv);
  for (int c = lane * V; c < N; c += 32 * V) {
    Pack<T> q = load16(row + c);
#pragma unroll
    for (int e = 0; e < V; ++e)
      q[e] = from_f<T>(act_fn((to_f(q[e]) - mean) * inv * g[c + e] + beta[c + e], gelu));
    *reinterpret_cast<uint4*>(out + (size_t)m * N + c) = q.u;
  }
}

template <typename T, int AMODE>
cudaError_t gemm(const GemmArgs<T>& args, cudaStream_t stream) {
  constexpr int bytes = gemm_smem_bytes<T>();
  // set once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      bytenet_gemm_kernel<T, AMODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((args.M + BM - 1) / BM, (args.N + BN - 1) / BN);
  bytenet_gemm_kernel<T, AMODE><<<grid, THREADS, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_act_rows(const T* in, const float* g, const float* beta, T* out, int M, int N,
                        int gelu, cudaStream_t stream) {
  bytenet_ln_act_kernel<T><<<(M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0,
                          stream>>>(in, g, beta, out, M, N, gelu);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* g1, const float* b1, const void* w1,
           const float* c1, const float* g2, const float* b2, const void* wc,
           const float* cc, const float* g3, const float* b3, const void* w2,
           const float* c2, void* sa, void* sp, void* sq, void* s2, void* y, int B, int L,
           int D, int H, int K, int dil, int gelu, cudaStream_t stream, int* launched) {
  const int M = B * L;
  const T* xt = static_cast<const T*>(x);
  T* at = static_cast<T*>(sa);   // act(LN1 x)
  T* pt = static_cast<T*>(sp);   // p
  T* qt = static_cast<T*>(sq);   // q (may be p's buffer)
  T* b_e = static_cast<T*>(s2);  // act(LN2 p), then act(LN3 q)
  GemmArgs<T> a1{at, static_cast<const T*>(w1), c1, nullptr, pt, M, D, H, 0, 0, 0, 0};
  GemmArgs<T> a2{b_e, static_cast<const T*>(wc), cc, nullptr, qt, M, K * H, H, L, H, K, dil};
  GemmArgs<T> a3{b_e, static_cast<const T*>(w2), c2, xt, static_cast<T*>(y), M, H, D,
                 0, 0, 0, 0};
  cudaError_t err;
  // *launched counts the kernels that were launched, in order
  if ((err = ln_act_rows<T>(xt, g1, b1, at, M, D, gelu, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = gemm<T, A_ROWS>(a1, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = ln_act_rows<T>(pt, g2, b2, b_e, M, H, gelu, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = gemm<T, A_CONV>(a2, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = ln_act_rows<T>(qt, g3, b3, b_e, M, H, gelu, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  if ((err = gemm<T, A_ROWS>(a3, stream)) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // namespace

// x, y [B, L, D]; w1 [H, D]; wc [H, K, H] ([out][tap][in]); w2 [D, H] (all in
// the activation type); g*/b*/c* f32; p, q [B, L, H] out (p == q allowed:
// q then overwrites p); sa [B, L, D] and s2 [B, L, H] scratch. D and H
// multiples of 32, K odd. dtype 0 = float32, 1 = bfloat16;
// act 0 = ReLU, 1 = GELU. Sets *launched to the number of kernels launched
// (6 on success) and returns a cudaError_t code (0 = all launched).
extern "C" int hd_bytenet_block_fwd(const void* x, const void* g1, const void* b1,
                                    const void* w1, const void* c1, const void* g2,
                                    const void* b2, const void* wc, const void* cc,
                                    const void* g3, const void* b3, const void* w2,
                                    const void* c2, void* sa, void* p, void* q, void* s2,
                                    void* y, int B, int L, int D, int H, int K, int dil, int act,
                                    int dtype, void* stream, int* launched) {
  *launched = 0;
  if (B <= 0 || L <= 0 || D <= 0 || H <= 0 || D % 32 || H % 32 || K <= 0 || K % 2 == 0 ||
      dil <= 0 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, f(g1), f(b1), w1, f(c1), f(g2), f(b2), wc, f(cc), f(g3),
                         f(b3), w2, f(c2), sa, p, q, s2, y, B, L, D, H, K, dil, act, s,
                         launched);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f(g1), f(b1), w1, f(c1), f(g2), f(b2), wc, f(cc),
                                 f(g3), f(b3), w2, f(c2), sa, p, q, s2, y, B, L, D, H, K, dil,
                                 act, s, launched);
  return (int)cudaErrorInvalidValue;
}
