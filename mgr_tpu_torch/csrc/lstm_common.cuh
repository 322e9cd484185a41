// Shared by bilstm_tm_fwd.cu and bilstm_tm_bwd.cu: the block and tile
// shape, the cell's rounding, the tensor-core step product, the
// per-direction split barrier and the occupancy cache (the cp.async
// helpers are in async_copy.cuh).
//
// The step product is mma.sync.m16n8k16 (bf16 operands, exact products,
// f32 sums). Its K axis is split over the block's 8 warps; each warp's
// partial sum goes through shared memory and is added in warp order, so
// the partition and the order depend only on H, never on the batch, the
// number of directions launched or the layout.
//
// K order inside one k16 step. The A fragment of lane (g8 = lane / 4,
// c4 = lane % 4) holds columns {2c4, 2c4+1, 2c4+8, 2c4+9} of rows g8 and
// g8+8, and the B fragment the same K rows of column g8. A sum over K does
// not depend on which K index carries which column, as long as A and B
// agree, so lane c4 takes the four CONTIGUOUS columns 4c4 .. 4c4+3: one
// 8-byte load per row gives its two A registers of that row, and the B
// fragment is four consecutive K values of one column.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

#include <map>
#include <mutex>
#include <utility>

namespace lstm {

constexpr int JS = 8;                 // hidden units per block (K1; K2 over one batch group)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 32;                // batch rows per tile: two m16 tiles; a thread per (row, unit)
constexpr int MAX_TILES = 8;          // tiles per launch (the carries stay in registers)
constexpr int MAX_B = RT * MAX_TILES; // batch rows per launch
constexpr int KPW = 4;                // k16 steps per warp of the z product
constexpr int MAX_H = WARPS * KPW * 16;  // 512: the widest H a launch takes
constexpr int RED_PITCH = 40;         // floats per row of a warp's partial z: 32 + 8,
                                      // so the fragment stores are free of bank conflicts
constexpr int RED_Z_FLOATS = WARPS * RT * RED_PITCH;
constexpr int BAR_STRIDE = 32;        // words between two barrier counters (own 128 B line)

// A block's tiling of the gate math and of the z product, by its hidden
// units JS_: a tile is RT rows x JS_ units, a thread per (row, unit). A
// warp's z product makes two m16n8 products a gate and k16 step: two m16
// tiles of one n8 tile (JS_ = 8: K1, and K2 over one batch group) or one
// m16 tile of two n8 tiles (JS_ = 16: K2 over batch groups). acc[p] below
// is product p of the two.
template <int JS_>
struct Tiling {
  static constexpr int RT = THREADS / JS_;  // rows a tile
  static constexpr int MT = RT / 16;        // m16 tiles a tile
  static constexpr int NT = JS_ / 8;        // n8 tiles a gate
  static constexpr int RED_PITCH = 4 * JS_ + 8;  // floats a row of a warp's partial z: 8 mod
                                                 // 32 words, so the fragment stores are free
                                                 // of bank conflicts
  static constexpr int RED_Z_FLOATS = WARPS * RT * RED_PITCH;
  static_assert(MT * NT == 2, "two m16n8 products a gate and k16 step");
};
static_assert(Tiling<JS>::RT == RT && Tiling<JS>::RED_PITCH == RED_PITCH, "K1's tiling");

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// A launch's tiling into G batch groups, shared by K1 and K2: a block owns
// JS hidden units of one direction for the rows of one group, and each
// (direction, group) meets on a barrier counter of its own.
//   - G = 1: JS = 8 over all rows of the launch (at most MAX_B = 256; gate
//     tiles of 32 rows, two m16 tiles of one n8 tile a gate).
//   - G = 2: JS = 16 over two groups of at most 64 rows (128 a launch; gate
//     tiles of 16 rows, one m16 tile of two n8 tiles a gate).
template <int G>
struct GroupTiling {
  static_assert(G == 1 || G == 2, "one or two batch groups");
  static constexpr int JS = G == 1 ? 8 : 16;      // hidden units a block
  static constexpr int RT = Tiling<JS>::RT;        // rows a gate tile
  static constexpr int MT = Tiling<JS>::MT;        // m16 tiles a gate tile
  static constexpr int NT = Tiling<JS>::NT;        // n8 tiles a gate
  static constexpr int MAX_ROWS = G == 1 ? MAX_B : 64;  // rows a group
  static constexpr int MAX_TILES = MAX_ROWS / RT;  // gate tiles a group: the carries
  static constexpr int LAUNCH_ROWS = G * MAX_ROWS; // rows a launch
};

// Rows of each group of a launch of nb rows: all of them for one group;
// else the launch split evenly, rounded up to m16 tiles (so a row keeps its
// place in its m16 tile under every tiling).
template <int G>
__host__ __device__ inline int group_rows(int nb) {
  return G == 1 ? nb : ((nb + G - 1) / G + 15) / 16 * 16;
}

// Words of the barrier scratch a call at batch B in `groups` batch groups
// needs: a counter per direction and group of each launch, each on its own
// line (0 for another number of groups).
inline int barrier_words(int B, int groups) {
  if (groups != 1 && groups != 2) return 0;
  const int rows = groups == 1 ? GroupTiling<1>::LAUNCH_ROWS : GroupTiling<2>::LAUNCH_ROWS;
  return 2 * groups * BAR_STRIDE * ((B + rows - 1) / rows);
}

// A row pitch of w 32-bit words padded to 8 mod 32 (a multiple of 8 words,
// so 32-byte aligned), which makes the m16 fragment reads of 8 bytes a
// lane free of bank conflicts.
__host__ __device__ inline int pad_words(int w) { return w + (((8 - w) % 32) + 32) % 32; }

// Row (t, b) of a stream: t * ld + b time-major, b * ld + t batch-major.
template <bool BM>
__device__ __forceinline__ size_t row_at(int t, int b, int ld) {
  return BM ? (size_t)b * ld + t : (size_t)t * ld + b;
}

// Keras hard_sigmoid, rounded as clip(0.2 * x + 0.5, 0, 1) is in JAX:
// the product and the sum each round (no fused multiply-add).
__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);
}

// Its slope as the TPU kernel takes it: nonzero (0.2) on the OPEN interval.
__device__ __forceinline__ bool hard_sigmoid_slope(float x) { return x > -2.5f && x < 2.5f; }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += A (16x16, rows) . B (16x8, columns); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Columns k .. k+3 of an H-long bf16 row, read at L2 (.cg: another block
// may have written the row during this launch, and L1 is not coherent);
// zero past H. A row is 2H bytes, so 8-byte aligned where H % 4 == 0 and
// only 4-byte aligned otherwise (H is even).
__device__ __forceinline__ uint2 ld_row4(const __nv_bfloat16* row, int k, int H) {
  uint2 v = make_uint2(0u, 0u);
  if ((H & 3) == 0) {
    if (k < H) v = __ldcg(reinterpret_cast<const uint2*>(row + k));
  } else {
    if (k < H) v.x = __ldcg(reinterpret_cast<const unsigned int*>(row + k));
    if (k + 2 < H) v.y = __ldcg(reinterpret_cast<const unsigned int*>(row + k + 2));
  }
  return v;
}

// The split barrier of one direction's blocks, on a counter that only
// grows (the wrapper zeroes it for each call). Arrive: after the block's
// stores and a __syncthreads, one thread publishes them at gpu scope
// (release fence, then the add). Wait: one thread spins on an acquire
// load until every block of the direction has arrived `target` times in
// all, then the block meets at a __syncthreads.
__device__ __forceinline__ void barrier_arrive(unsigned int* ctr) {
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
  }
}
__device__ __forceinline__ void barrier_wait(const unsigned int* ctr, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// One warp's partial z = h_prev . U_d[:, block's 32 columns] for rows
// b0 .. b0+31 (two m16 tiles; n-tile g = gate g, its column n = unit j0+n),
// over the warp's k16 steps warp*KPW .. warp*KPW+KPW-1 of ceil(H/16).
// h rows at or past B and columns at or past H enter as zero. ub(i, g)
// gives the B fragment of step i and gate g (zero past H).
template <bool BM, typename UFrag>
__device__ __forceinline__ void z_partial(const __nv_bfloat16* hs, int t_prev, int b0, int B,
                                          int ld, int H, UFrag ub, float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int KS = (H + 15) >> 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][g][e] = 0.0f;
  uint2 a[2][KPW][2];  // [m16 tile][k step][row g8, row g8 + 8]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = b0 + mt * 16 + g8 + 8 * hh;
      const __nv_bfloat16* row = hs + (b < B ? row_at<BM>(t_prev, b, ld) * H : 0);
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const int ks = warp * KPW + i;
        a[mt][i][hh] = (b < B && ks < KS) ? ld_row4(row, ks * 16 + 4 * c4, H) : make_uint2(0u, 0u);
      }
    }
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    if (warp * KPW + i >= KS) break;  // uniform over the warp
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (b0 + mt * 16 >= B) break;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint2 b = ub(i, g);
        mma16816(acc[mt][g], a[mt][i][0].x, a[mt][i][1].x, a[mt][i][0].y, a[mt][i][1].y, b.x,
                 b.y);
      }
    }
  }
}

// The B fragment of lane (g8, c4) for k16 step ks and gate g of the z
// product: U_d[k .. k+3, g, u] with k = 16 ks + 4 c4, u = j0 + g8, as two
// bf16 pairs; zero past H in k or u. U_d is (H, 4H), gate-blocked.
__device__ __forceinline__ uint2 u_col_frag(const __nv_bfloat16* Ud, int ks, int g, int j0,
                                            int lane, int H) {
  const int u = j0 + (lane >> 2), k = ks * 16 + 4 * (lane & 3);
  const size_t H4 = 4 * (size_t)H;
  __nv_bfloat16 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = (u < H && k + q < H) ? Ud[(size_t)(k + q) * H4 + (size_t)g * H + u]
                                : __float2bfloat16_rn(0.0f);
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// One warp's partial z = h_prev . U_d[:, block's 4 JS_ columns] for the RT
// rows r0 .. r0+RT-1 of h rows staged in shared memory, as z_partial
// computes it from device memory: the same fragments, products and order.
// hf(r, k) gives columns k .. k+3 of staged row r (k < H; a pair past the
// row is zeroed here). Rows at or past `rows` and columns at or past H
// enter as zero. ub(i, c) gives the B fragment of step i and n8 tile c =
// g * NT + n (gate g's units j0 + 8n ..).
template <int JS_, typename HFrag, typename UFrag>
__device__ __forceinline__ void z_partial_staged(HFrag hf, int r0, int rows, int H, UFrag ub,
                                                 float (&acc)[2][4][4]) {
  constexpr int MT = Tiling<JS_>::MT, NT = Tiling<JS_>::NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int KS = (H + 15) >> 4;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][g][e] = 0.0f;
  uint2 a[MT][KPW][2];  // [m16 tile][k step][row g8, row g8 + 8]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + mt * 16 + g8 + 8 * hh;
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const int k = (warp * KPW + i) * 16 + 4 * c4;
        uint2 v = make_uint2(0u, 0u);
        if (r < rows && k < H) {
          v = hf(r, k);
          if (k + 2 >= H) v.y = 0u;  // H = 2 mod 4: the row's last pair
        }
        a[mt][i][hh] = v;
      }
    }
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    if (warp * KPW + i >= KS) break;  // uniform over the warp
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int mt = MT == 2 ? p : 0, n = NT == 2 ? p : 0;
      if (r0 + mt * 16 >= rows) break;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint2 b = ub(i, g * NT + n);
        mma16816(acc[p][g], a[mt][i][0].x, a[mt][i][1].x, a[mt][i][0].y, a[mt][i][1].y, b.x,
                 b.y);
      }
    }
  }
}

// Partial z fragments of one warp into red [WARPS][RT][RED_PITCH] (Tiling<JS_>).
template <int JS_ = JS>
__device__ __forceinline__ void store_z_partial(float* red, const float (&acc)[2][4][4]) {
  using TL = Tiling<JS_>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  float* base = red + warp * TL::RT * TL::RED_PITCH;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int mt = TL::MT == 2 ? p : 0, n = TL::NT == 2 ? p : 0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float* q = base + (mt * 16 + g8) * TL::RED_PITCH + g * JS_ + 8 * n + 2 * c4;
      *reinterpret_cast<float2*>(q) = make_float2(acc[p][g][0], acc[p][g][1]);
      *reinterpret_cast<float2*>(q + 8 * TL::RED_PITCH) = make_float2(acc[p][g][2], acc[p][g][3]);
    }
  }
}

// The product's value at (tile row r, gate g, unit j): the warps' partial
// sums added in warp order.
template <int JS_ = JS>
__device__ __forceinline__ float z_sum(const float* red, int r, int g, int j) {
  using TL = Tiling<JS_>;
  const float* p = red + r * TL::RED_PITCH + g * JS_ + j;
  float s = p[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += p[w * TL::RT * TL::RED_PITCH];
  return s;
}

// Blocks per SM of `kernel` at this shared memory size. The kernel's
// shared memory limit is raised once per device to the most a block may
// opt in to (the limit is state of the function; lowering it for a
// narrow launch broke a later, wider one with error 720), and the
// occupancy is found once per (kernel, device, size).
inline cudaError_t blocks_per_sm(const void* kernel, int device, size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> optin;  // raised limit in bytes
  static std::map<std::pair<std::pair<const void*, int>, size_t>, int> known;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err;
  const auto fd = std::make_pair(kernel, device);
  if (optin.find(fd) == optin.end()) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    optin[fd] = limit;
  }
  if (smem > (size_t)optin[fd]) return cudaErrorInvalidValue;  // H too wide
  const auto key = std::make_pair(fd, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess) known[key] = *per_sm;
  return err;
}

}  // namespace lstm
