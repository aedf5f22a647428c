// Pieces the Hopper designs of K2 (bytenet_block.cu) and K4
// (bytenet_block_bwd.cu) share: a consumer warp's release of a ring stage,
// the conv's rows that lie in another chain, an f32 tile of 128 rows of
// products in shared memory that an epilogue walks a warp a row, bf16
// quads, and the row sums of a cluster's column tiles through distributed
// shared memory.
#pragma once

#include <cooperative_groups.h>

#include "gemm_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace hd {
namespace bt {

namespace cg = cooperative_groups;

// A consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(empty);
}

// Whether 64 rows whose first row sits at `first` in its chain have rows
// whose row + shift lies in another chain (or past either end)
__device__ __forceinline__ bool crosses(int first, int shift, int L) {
  return shift != 0 &&
         (first + 63 >= L || (shift > 0 ? first + 63 >= L - shift : first < -shift));
}

// Zero the rows of a landed 64-row box (its 128-byte rows, the warpgroup's
// thread gt taking rows gt / 8 + 16 k and the 16-byte column gt % 8) whose
// row + shift lies in another chain; lpos[k] the rows' chain positions
__device__ __forceinline__ void zero_rows(unsigned char* box, const int (&lpos)[4], int shift,
                                          int L, int gt) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lpos[k] + shift < 0 || lpos[k] + shift >= L)
      *reinterpret_cast<uint4*>(box + (gt / 8 + 16 * k) * 128 + (gt & 7) * 16) =
          make_uint4(0, 0, 0, 0);
}

// An f32 [128][COLS] tile in shared memory whose 16-byte groups of a row
// are stored XOR the row's low three bits, so that a warp writing a
// thread's m16n8 pairs or reading a row's 16-byte groups meets few bank
// conflicts
template <int COLS = 128> struct DTile {
  float* t;
  __device__ __forceinline__ float* at(int r, int c) const {
    return t + r * COLS + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
  }
};

// four bf16 as f32, and four f32 stored as bf16
__device__ __forceinline__ float4 unpack4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(gemm::bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(tc::pack(a, b), tc::pack(c, d));
}

// The sums of a tile's ROWS rows over every column of the cluster's blocks:
// each block's (sRow, written before the call), then every block in rank
// order, so that every block holds the same sums; thread r < ROWS returns
// row r's. Every thread of every block of the cluster calls it.
template <int ROWS>
__device__ __forceinline__ float2 cluster_row_sums(float2* sRow, cg::cluster_group& cluster) {
  cluster.sync();  // every block's sRow is written
  float2 tot = make_float2(0.f, 0.f);
  if (threadIdx.x < ROWS)
    for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
      const float2 w = *cluster.map_shared_rank(sRow + threadIdx.x, k);
      tot.x += w.x;
      tot.y += w.y;
    }
  cluster.sync();  // every block has read the others' sRow
  return tot;
}

}  // namespace bt
}  // namespace hd
