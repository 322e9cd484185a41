// LSTM backward recurrences for Hopper (sm_90a): the adjoints of the three
// entries of bilstm_tm_fwd.cu.
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_tm_bwd_kernel
// (launched by _tm_bwd_call from the custom VJP _tm_core_bwd of
// pallas_bilstm_tm). It is the adjoint of bilstm_tm_fwd.cu. The entry
// lstm_tm_bwd runs ONE direction of it and replaces _tm1_bwd_kernel
// (launched by _tm1_bwd_call from the custom VJP _tm1_core_bwd of
// pallas_lstm_tm, the direction-sharded tensor-parallel path): the blocks
// of one direction only, whose walk order is that direction's (reverse = 1
// walks t = 0 -> T-1). The entry lstm_scan_bwd replaces _bwd_kernel
// (launched by _lstm_scan_bwd_call from the custom VJP _scan_core_bwd of
// pallas_recurrent_scan, the batch-major layer API): the same blocks on the
// batch-major layout, every one of the D directions walking t = T-1 -> 0.
// Same function:
//
//   a forward-scanning direction walks t = T-1 -> 0 (its pre-state is at
//   t-1), a reverse-scanning one (direction 1 of the time-major layer)
//   walks t = 0 -> T-1 (its pre-state is at t+1); the pre-state is zero
//   past either end.
//     z     = xp_d[t] + bf16(h_prev) . U_d                 (recomputed, f32)
//     i,f,o = hard_sigmoid(z);  g = tanh z;  tc = tanh(c_t)
//     dh    = dhs[t] + dh_carry;  do = dh tc;  dc = dc_carry + dh o (1 - tc^2)
//     dz    = [dc g hs'(z_i), dc c_prev hs'(z_f), dc i (1 - g^2), do hs'(z_o)]
//             with hs'(x) = 0.2 on the OPEN interval (-2.5, 2.5), else 0
//     dh_carry = bf16(dz) . U_d^T  (f32 sums);  dc_carry = dc f
//   h_prev, c_prev and c_t are the STORED bf16 streams of the forward, as
//   the TPU kernel reads them. dz is stored in bf16 (gate-blocked, original
//   time positions); dxp = dz, and dU = sum_t h_prev^T dz is one GEMM
//   outside the kernel, as in the JAX package.
//
// Layouts: time-major xp0, xp1 (T, B, 4H) bf16; U (2, H, 4H) bf16; hs*, cs*,
// dhs* (T, B, H) bf16; dz0, dz1 (T, B, 4H) bf16. Batch-major xp, dz (D, B,
// T, 4H); U (D, H, 4H); hs, cs, dhs (D, B, T, H). As in the forward, the
// kernel is a template over the layout (row (t, b) at t * ld + b or
// b * ld + t), so the batch-major buffers are read and dz written in place.
//
// What bounds it on this card: latency, step by step. The walk is serial
// in t and every unit of a step needs the dz of all units of the step before
// (dh_carry sums over all 4H columns), so each block gathers the last
// step's dz rows from L2 (8H bytes a row) and meets its direction's blocks
// on a barrier every step. Between arrive and wait it recomputes the next
// step's z, whose operands (the h_{t_pre} rows, xp_t, c and dhs) come from
// device memory. On an H100 at T=1900, H=500, B=128, with one 8-unit slice
// a block over all rows (the design of one group), the launch took 46 ms:
// without the z recompute 24, without its loads 28, without the dz gather
// 37, without the barrier wait 45. So the loads of the recompute, one
// dependent round a 32-row tile, led; the tensor-core work is ~2 us a step.
//
// Design: ONE cooperative launch runs all T steps. The grid is directions x
// G batch groups x unit slices: a block owns JS hidden units of one
// direction for the rows of one group, and each (direction, group) walks on
// a barrier counter of its own (the rows are independent, so the groups
// never wait for each other). The tiling is a template argument, G:
//   - G = 1: JS = 8 over all rows of the launch (at most MAX_B = 256; gate
//     tiles of 32 rows). The per-step floor at small B.
//   - G = 2: JS = 16 (two n8 tiles a gate) over two groups of at most 64
//     rows (128 a launch; gate tiles of 16 rows): a block gathers and
//     recomputes only its group's rows, and walks half as many m16 tiles a
//     step with the same MMA work. At H = 500 or 512 the grid is 2 x 32 x 2
//     = 128 blocks, one an SM. Its z recompute takes its operands in one
//     round: the group's h_{t_pre} rows are staged in shared memory by
//     asynchronous copies, a commit group per tile, and each thread's own
//     xp, c and dhs values of the next step are read into registers before
//     the barrier wait of the step before, so their latency overlaps the
//     walk. 32 ms at B=128 on the same card.
//   The wrapper (kernels/bilstm_tm.py::batch_groups, K1's rule too) chooses
//   G from B, H and the SM count; the host entry refuses a grid that cannot
//   be co-resident.
// A thread owns a (row, unit) of a gate tile (RT x JS = 256) and keeps its
// dc carries in registers. The only exchange is dz, through the kernel's
// own bf16 output.
//   - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 sums; lstm_common.cuh), K split over the 8 warps with partial
//     sums added in warp order through shared memory: the z recompute as
//     in bilstm_tm_fwd.cu (K = H, KPW = 4 k16 steps a warp), and dh_carry =
//     bf16(dz_{t_last}) . U_d[slice, :]^T with K = the flat 4H axis (125
//     k16 steps at H=500, KPW_DH = 16 a warp, in two chains of products).
//     The partition depends only on H, never on the tiling, the rows or
//     the group a row falls in: every tiling, the two-direction launch,
//     one direction (lstm_tm_bwd) and the batch-major walk give bit-equal
//     dz for a row, and two launches give identical bits.
//   - U_d resident in bf16: the dh_carry operand (U_d's JS rows, 16 k16
//     steps a warp) in registers, 4 JS a thread; the z operand (U_d's 4 JS
//     columns) in shared memory as B fragments.
//   - The z recompute is off the walk. z_t needs only the streams the
//     forward stored (xp_t, h_{t_pre}), as the TPU kernel's direction_step
//     does, so right after arriving at step s's barrier a block recomputes
//     step s+1's z and everything that does not depend on the walk: the
//     gates, tanh c_t, c_{t_pre}, dhs[t], folded into 6 words per (row,
//     unit) in shared memory (dhs[t] and c_{t_pre}, bf16 values, share
//     one). After the wait only the dependent part is left: the dz gather,
//     the dh_carry products, 3 multiply-adds per gate and the dz store.
//   - The dz gather: rows are 8H bytes (16-byte aligned), so each m16 row
//     tile of dz_{t_last} is staged whole with 16-byte cp.async.cg copies
//     (L2 only: other blocks wrote it during the launch) through a ring of
//     two buffers, so tile m+1 (and m+2's issue) overlaps tile m's
//     products. The smem row pitch is padded to 8 mod 32 words, which
//     makes the fragment reads free of bank conflicts.
//   - A split barrier per (direction, group) as in bilstm_tm_fwd.cu.
// Shared memory (bytes; at most 232,448 a block). G = 1 at H=500: U_d's z
// fragments 32,768; the dz ring 2 x 16 x 4000 = 128,000 (the z partial
// sums, 40,960, reuse it between arrive and wait); dh partial sums 8,192;
// the folded values 6 x 4 x 8 x min(B, 256): 49,152 at 256 rows; 218,112 in
// all (222,208 at H=512). G = 2: z fragments 65,536 (KS x 4 gates x 2 n8
// tiles x 256); the ring 128,000 (132,096 at H=512), which between arrive
// and wait holds the z partial sums (36,864) and the staged h rows (64 x
// 1,056); 8,192; folded values 6 x 4 x 16 x 64 = 24,576: 226,304 at H=500
// and 230,400 at H=512 (MAX_H), where a seventh folded word (c_{t_pre}
// apart) would not fit.
// The host entry runs a larger batch as consecutive launches over slices of
// rows.
// What it leaves: wgmma (M is the batch: at most 64 rows a block); the z
// recompute still in series with the walk (~18 of the 32 ms at B=128, G =
// 2: its h copies ~5.5, the rest its products, partial sums and gates;
// warps that recompute while others walk would hide it, but the K split
// over 8 warps fixes the bits); a cluster-shared dz gather (TMA multicast
// or distributed shared memory across a direction-group's blocks), which
// needs a cluster launch that is also cooperative, whose co-residency has
// not been measured on this card; K6's layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

constexpr int KPW_DH = 16;     // k16 steps per warp of the dh_carry product (4H <= 2048)
constexpr int NPREP = 6;       // folded words per (row, unit)
constexpr int RED_DH_FLOATS = WARPS * THREADS;  // [WARPS][RT][JS] with RT x JS = THREADS

// Row pitch of the dz ring in 32-bit words: a dz row is 2H words.
__host__ __device__ inline int ring_pitch_words(int H) { return pad_words(2 * H); }

// Between arrive and wait the ring holds red_z [WARPS][RT][RED_PITCH] f32
// and, in two groups, the group's h_{t_pre} rows [MAX_ROWS][h pitch] (bf16).
// Byte offsets from the ring.
template <int G>
struct Stage {
  __host__ __device__ static int h_pitch(int H) { return 4 * pad_words(H / 2); }  // bytes
  __host__ __device__ static size_t h() {
    return round16(sizeof(float) * Tiling<GroupTiling<G>::JS>::RED_Z_FLOATS);
  }
  __host__ __device__ static size_t end(int H) {
    return h() + (G == 1 ? 0 : (size_t)GroupTiling<G>::MAX_ROWS * h_pitch(H));
  }
};

template <int G>
__host__ __device__ inline size_t ring_bytes(int H) {
  const size_t ring = (size_t)2 * 16 * ring_pitch_words(H) * 4;
  const size_t stage = Stage<G>::end(H);
  return round16(ring > stage ? ring : stage);
}

// Waits until at most n (0 .. 3) of this thread's commit groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

template <int G>
__host__ __device__ inline size_t uz_bytes(int H) {
  return (size_t)((H + 15) / 16) * 4 * GroupTiling<G>::NT * 32 * sizeof(uint2);
}

// Dynamic shared memory of a call at B rows and width H: its first launch,
// the largest, takes min(B, LAUNCH_ROWS) rows.
template <int G>
size_t smem_bytes(int B, int H) {
  using TL = GroupTiling<G>;
  const int nb = B < TL::LAUNCH_ROWS ? B : TL::LAUNCH_ROWS;
  return uz_bytes<G>(H) + ring_bytes<G>(H) + sizeof(float) * RED_DH_FLOATS +
         round16(sizeof(float) * NPREP * (size_t)group_rows<G>(nb) * TL::JS);
}

template <bool BM, int G>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const __nv_bfloat16* __restrict__ xp0,
                const __nv_bfloat16* __restrict__ xp1,
                const __nv_bfloat16* __restrict__ U0,
                const __nv_bfloat16* __restrict__ U1,
                const __nv_bfloat16* __restrict__ hs0,
                const __nv_bfloat16* __restrict__ hs1,
                const __nv_bfloat16* __restrict__ cs0,
                const __nv_bfloat16* __restrict__ cs1,
                const __nv_bfloat16* __restrict__ dhs0,
                const __nv_bfloat16* __restrict__ dhs1,
                __nv_bfloat16* dz0, __nv_bfloat16* dz1, unsigned int* barrier,
                int T, int B, int ld, int H, int slices, int d0, int rev_mask, int grows) {
  // B <= LAUNCH_ROWS rows of a batch laid out as row_at<BM>, in groups of
  // grows rows. Block (dl, group, slice) at blockIdx.x = (dl * G + group) *
  // slices + slice; the grid covers directions d0 .. d0 + gridDim.x / (G *
  // slices) - 1; direction d's forward scan ran in reverse where bit d of
  // rev_mask is set.
  using TL = GroupTiling<G>;
  constexpr int JS_ = TL::JS, RT_ = TL::RT, MT = TL::MT, NT = TL::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dl = blockIdx.x / (G * slices);  // direction within the launch
  const int grp = (blockIdx.x / slices) % G;
  const int d = d0 + dl;
  const bool rev = (rev_mask >> d) & 1;
  const int j0 = (blockIdx.x % slices) * JS_;
  const int gb0 = grp * grows;  // the group's first row in the launch
  const int Bg = min(grows, B - gb0);
  if (Bg <= 0) return;  // an empty group: no other group waits on its counter
  const size_t r0 = BM ? (size_t)gb0 * ld : (size_t)gb0;  // its first row at t = 0
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int gr = tid / JS_, gj = tid % JS_;  // this thread's (tile row, unit) of the gate math
  const int unit = j0 + gj;
  const bool unit_ok = unit < H;
  const size_t H4 = 4 * (size_t)H;
  const int H4i = 4 * H;
  const int tiles = (Bg + RT_ - 1) / RT_;
  const int mtiles = (Bg + 15) / 16;
  const int KS = (H + 15) >> 4;          // k16 steps of the z product
  const int KS_DH = (H4i + 15) >> 4;     // k16 steps of the dh_carry product
  const int pitch = 4 * ring_pitch_words(H);  // bytes
  const int prep_n = Bg * JS_;                // folded words per kind
  unsigned int* ctr = barrier + (dl * G + grp) * BAR_STRIDE;

  // Shared memory: uz_s [KS][4 gates x NT][32 lanes] uint2 | ring (2 x 16
  // rows x pitch, or red_z [WARPS][RT][RED_PITCH] f32 between arrive and
  // wait) | red_dh [WARPS][RT][JS] f32 | prep [NPREP][Bg][JS] 32-bit words.
  uint2* uz_s = reinterpret_cast<uint2*>(smem);
  unsigned char* ring = smem + uz_bytes<G>(H);
  float* red_z = reinterpret_cast<float*>(ring);
  float* red_dh = reinterpret_cast<float*>(ring + ring_bytes<G>(H));
  float* prep = red_dh + RED_DH_FLOATS;

  const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
  const __nv_bfloat16* xp = (d == 0 ? xp0 : xp1) + r0 * H4;
  const __nv_bfloat16* hs = (d == 0 ? hs0 : hs1) + r0 * H;
  const __nv_bfloat16* cs = (d == 0 ? cs0 : cs1) + r0 * H;
  const __nv_bfloat16* dhs = (d == 0 ? dhs0 : dhs1) + r0 * H;
  __nv_bfloat16* dz = (d == 0 ? dz0 : dz1) + r0 * H4;

  // The z product's B fragments: n8 tile c = g * NT + n holds gate g's
  // units j0 + 8n .. j0 + 8n + 7.
  for (int e = tid; e < KS * 4 * NT * 32; e += THREADS) {
    const int c = (e >> 5) % (4 * NT), ks = (e >> 5) / (4 * NT);
    uz_s[e] = u_col_frag(Ud, ks, c / NT, j0 + 8 * (c % NT), e & 31, H);
  }
  // dh_carry's B fragments: U_d[u, k .. k+3] with u = j0 + 8n + g8 (a row of
  // U_d, 8H bytes: an 8-byte load), zero past H or 4H.
  uint2 ubd[NT][KPW_DH];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < KPW_DH; ++i) {
      const int u = j0 + 8 * n + g8, k = (warp * KPW_DH + i) * 16 + 4 * c4;
      ubd[n][i] = (u < H && k < H4i)
                      ? *reinterpret_cast<const uint2*>(Ud + (size_t)u * H4 + k)
                      : make_uint2(0u, 0u);
    }
  __syncthreads();

  float dc_reg[TL::MAX_TILES];  // dc carry of row tile * RT + gr, unit j0 + gj
#pragma unroll
  for (int tile = 0; tile < TL::MAX_TILES; ++tile) dc_reg[tile] = 0.0f;

  // Step s's z recompute and the values that do not depend on the walk,
  // folded per (row, unit) into prep, between arrive and wait (and once
  // before the walk), while the ring is free. fold() writes row b's words.
  auto fold = [&](int b, const float (&z)[4], float ct, __nv_bfloat16 dh_in,
                  __nv_bfloat16 cp) {
    const float ig = hard_sigmoid(z[0]);
    const float fg = hard_sigmoid(z[1]);
    const float gg = tanhf(z[2]);
    const float og = hard_sigmoid(z[3]);
    const float tc = tanhf(ct);
    float* p = prep + b * JS_ + gj;
    // dh = dhs[t] (+ dh_carry); dz_f = (dc * c_pre) * 0.2: both bf16 values.
    reinterpret_cast<uint32_t*>(p)[0] =
        pack_bf16(dh_in, hard_sigmoid_slope(z[1]) ? cp : __float2bfloat16_rn(0.0f));
    p[1 * prep_n] = og * (1.0f - tc * tc);                // dc += dh * this
    p[2 * prep_n] = hard_sigmoid_slope(z[0]) ? gg : 0.0f;  // dz_i = (dc * this) * 0.2
    p[3 * prep_n] = ig * (1.0f - gg * gg);                // dz_g = dc * this
    p[4 * prep_n] = hard_sigmoid_slope(z[3]) ? tc : 0.0f;  // dz_o = (dh * this) * 0.2
    p[5 * prep_n] = fg;                                   // dc_carry = dc * this
  };
  // In two groups the group's h_{t_pre} rows are staged in the ring by
  // asynchronous copies, a commit group per tile, so that each tile's
  // products overlap the copies of the tiles after it (8 bytes a copy where
  // 4 | H: rows of 2H bytes are 8-byte aligned; else 4). The rest of a
  // thread's operands, those of its own (row, unit) in each tile (xp's 4
  // gates, c_t, dhs_t, c_{t_pre}), it reads into registers as bf16 pairs
  // before the wait of the step before (load_next), so that their latency
  // overlaps that step's walk.
  const int hp = Stage<G>::h_pitch(H);
  unsigned char* hst = ring + Stage<G>::h();
  const int cw = (H & 3) == 0 ? 8 : 4;  // bytes a copy
  const int hq = 2 * H / cw;            // copies an h row
  auto stage_h = [&](int t_pre, int r) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(hs + row_at<BM>(t_pre, r, ld) * H);
    unsigned char* dst = hst + r * hp;
    for (int q = lane; q < hq; q += 32) {
      if (cw == 8) cp_async8(dst + 8 * q, src + 8 * q); else cp_async4(dst + 4 * q, src + 4 * q);
    }
  };
  uint32_t nx[G == 1 ? 1 : TL::MAX_TILES][4];  // (x_i, x_f), (x_g, x_o), (c_t, dhs_t), (c_pre, 0)
  auto load_next = [&](int s) {
    if constexpr (G != 1) {
      const int t = rev ? s : T - 1 - s;
      const int t_pre = rev ? t + 1 : t - 1;
      const bool has_pre = t_pre >= 0 && t_pre < T;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
      for (int tile = 0; tile < TL::MAX_TILES; ++tile) {
        const int b = tile * RT_ + gr;
        nx[tile][0] = nx[tile][1] = nx[tile][2] = nx[tile][3] = 0u;
        if (tile < tiles && unit_ok && b < Bg) {
          const size_t row = row_at<BM>(t, b, ld);
          const __nv_bfloat16* x = xp + row * H4 + unit;
          nx[tile][0] = pack_bf16(x[0], x[H]);
          nx[tile][1] = pack_bf16(x[2 * (size_t)H], x[3 * (size_t)H]);
          nx[tile][2] = pack_bf16(cs[row * H + unit], dhs[row * H + unit]);
          if (has_pre) nx[tile][3] = pack_bf16(cs[row_at<BM>(t_pre, b, ld) * H + unit], zero);
        }
      }
    }
  };
  auto bf_lo = [](uint32_t w) { return __ushort_as_bfloat16((unsigned short)(w & 0xffffu)); };
  auto bf_hi = [](uint32_t w) { return __ushort_as_bfloat16((unsigned short)(w >> 16)); };
  auto precompute = [&](int s) {
    const int t = rev ? s : T - 1 - s;
    const int t_pre = rev ? t + 1 : t - 1;
    const bool has_pre = t_pre >= 0 && t_pre < T;
    auto ub = [&](int i, int c) { return uz_s[((warp * KPW + i) * 4 * NT + c) * 32 + lane]; };
    if constexpr (G == 1) {
      // One group: each tile reads its operands from device memory.
#pragma unroll 1
      for (int tile = 0; tile < tiles; ++tile) {
        const int b0 = tile * RT_;
        const int b = b0 + gr;
        const bool mine = unit_ok && b < Bg;
        // This thread's operands, read ahead of the z product.
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ct = 0.0f;
        __nv_bfloat16 dh_in = __float2bfloat16_rn(0.0f), cp = dh_in;
        if (mine) {
          const size_t row = row_at<BM>(t, b, ld);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            x[g] = __bfloat162float(xp[row * H4 + (size_t)g * H + unit]);
          ct = __bfloat162float(cs[row * H + unit]);
          dh_in = dhs[row * H + unit];
          if (has_pre) cp = cs[row_at<BM>(t_pre, b, ld) * H + unit];
        }
        if (has_pre) {
          if (tile > 0) __syncthreads();  // the previous tile's readers are done with red_z
          float acc[2][4][4];
          z_partial<BM>(hs, t_pre, b0, Bg, ld, H, ub, acc);
          store_z_partial(red_z, acc);
          __syncthreads();
        }
        if (mine) {
          float z[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = has_pre ? x[g] + z_sum(red_z, gr, g, gj) : x[g];
          fold(b, z, ct, dh_in, cp);
        }
      }
    } else {
      if (has_pre) {
        for (int tile = 0; tile < tiles; ++tile) {
          const int end = (tile + 1) * RT_ < Bg ? (tile + 1) * RT_ : Bg;
          for (int r = tile * RT_ + warp; r < end; r += WARPS) stage_h(t_pre, r);
          cp_async_commit();
        }
      }
#pragma unroll
      for (int tile = 0; tile < TL::MAX_TILES; ++tile) {
        if (tile >= tiles) break;  // uniform over the block
        const int r0 = tile * RT_;
        const int b = r0 + gr;
        if (has_pre) {
          cp_async_wait_pending(tiles - 1 - tile);
          __syncthreads();  // the tile's h rows landed for every warp (and red_z is free)
          float acc[2][4][4];
          z_partial_staged<JS_>(
              [&](int r, int k) {
                return *reinterpret_cast<const uint2*>(hst + (size_t)r * hp + 2 * k);
              },
              r0, Bg, H, ub, acc);
          store_z_partial<JS_>(red_z, acc);
          __syncthreads();
        }
        if (unit_ok && b < Bg) {
          const uint32_t* w = nx[tile];
          const float x[4] = {__bfloat162float(bf_lo(w[0])), __bfloat162float(bf_hi(w[0])),
                              __bfloat162float(bf_lo(w[1])), __bfloat162float(bf_hi(w[1]))};
          float z[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = has_pre ? x[g] + z_sum<JS_>(red_z, gr, g, gj) : x[g];
          fold(b, z, __bfloat162float(bf_lo(w[2])), bf_hi(w[2]), bf_lo(w[3]));
        }
      }
    }
  };

  // m16 row tile m of dz_{t_last} into ring buffer m & 1: warp w stages
  // rows w and w + 8, its lanes striding over the row's 16-byte chunks.
  auto stage_dz = [&](int t_last, int m) {
    unsigned char* buf = ring + (size_t)(m & 1) * 16 * pitch;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp + 8 * rr, b = m * 16 + r;
      if (b < Bg) {
        const __nv_bfloat16* src = dz + row_at<BM>(t_last, b, ld) * H4;
        for (int q = lane; q < H / 2; q += 32) cp_async16(buf + r * pitch + 16 * q, src + 8 * q);
      }
    }
    cp_async_commit();
  };

  load_next(0);
  precompute(0);
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int t_last = rev ? t - 1 : t + 1;  // the step walked before this one
    if (s + 1 < T) load_next(s + 1);
    if (s > 0) {
      barrier_wait(ctr, (unsigned int)(s * slices));  // dz_{t_last} is in the dz output
      stage_dz(t_last, 0);
      if (mtiles > 1) stage_dz(t_last, 1);
    }
#pragma unroll
    for (int tile = 0; tile < TL::MAX_TILES; ++tile) {
      if (tile >= tiles) break;  // uniform over the block
      if (s > 0) {
        // dh_carry of the tile's m16 tiles: bf16(dz_{t_last}) . U_d[slice, :]^T.
#pragma unroll
        for (int h2 = 0; h2 < MT; ++h2) {
          const int m = MT * tile + h2;
          if (m >= mtiles) break;
          if (m + 1 < mtiles) cp_async_wait<1>(); else cp_async_wait<0>();
          __syncthreads();  // tile m landed for every warp (and red_dh's readers are done)
          const unsigned char* buf = ring + (size_t)(m & 1) * 16 * pitch;
          float acc0[NT][4], acc1[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.0f;
#pragma unroll
          for (int i = 0; i < KPW_DH; ++i) {
            const int ks = warp * KPW_DH + i;
            if (ks >= KS_DH) break;  // uniform over the warp
            const int k = ks * 16 + 4 * c4;
            uint2 lo = *reinterpret_cast<const uint2*>(buf + g8 * pitch + 2 * k);
            uint2 hi = *reinterpret_cast<const uint2*>(buf + (g8 + 8) * pitch + 2 * k);
            if (k >= H4i) lo = hi = make_uint2(0u, 0u);  // past the row: the ring's padding
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (i & 1)  // two chains of products, added at the end
                mma16816(acc1[n], lo.x, hi.x, lo.y, hi.y, ubd[n][i].x, ubd[n][i].y);
              else
                mma16816(acc0[n], lo.x, hi.x, lo.y, hi.y, ubd[n][i].x, ubd[n][i].y);
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float* p = red_dh + (warp * RT_ + h2 * 16 + g8) * JS_ + 8 * n + 2 * c4;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc0[n][0] + acc1[n][0], acc0[n][1] + acc1[n][1]);
            *reinterpret_cast<float2*>(p + 8 * JS_) =
                make_float2(acc0[n][2] + acc1[n][2], acc0[n][3] + acc1[n][3]);
          }
          __syncthreads();  // buffer m & 1 is free, and the partial sums are visible
          if (m + 2 < mtiles) stage_dz(t_last, m + 2);
        }
      }
      const int b = tile * RT_ + gr;
      if (unit_ok && b < Bg) {
        const float* p = prep + b * JS_ + gj;
        const uint32_t w0 = reinterpret_cast<const uint32_t*>(p)[0];
        float dh = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w0 & 0xffffu)));
        const float cp = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w0 >> 16)));
        if (s > 0) {
          const float* q = red_dh + gr * JS_ + gj;
          float carry = q[0];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) carry += q[w * RT_ * JS_];
          dh += carry;
        }
        const float dc = dc_reg[tile] + dh * p[1 * prep_n];
        const size_t row4 = row_at<BM>(t, b, ld) * H4 + unit;
        dz[row4] = __float2bfloat16_rn((dc * p[2 * prep_n]) * 0.2f);
        dz[row4 + (size_t)H] = __float2bfloat16_rn((dc * cp) * 0.2f);
        dz[row4 + 2 * (size_t)H] = __float2bfloat16_rn(dc * p[3 * prep_n]);
        dz[row4 + 3 * (size_t)H] = __float2bfloat16_rn((dh * p[4 * prep_n]) * 0.2f);
        dc_reg[tile] = dc * p[5 * prep_n];
      }
    }
    if (s + 1 < T) {
      __syncthreads();  // the step's dz stores are done, and every read of prep and the ring
      barrier_arrive(ctr);
      precompute(s + 1);
    }
  }
}

// Runs the backward walk of directions d0 .. d0 + ndirs - 1 on `stream` in
// G batch groups, as one cooperative launch per LAUNCH_ROWS batch rows, each
// on its own counters in `barrier`. Returns the first cudaError_t: a grid
// that cannot be co-resident is refused, never run.
template <bool BM, int G>
cudaError_t launch_tiled(const void* xp0, const void* xp1, const void* U0, const void* U1,
                         const void* hs0, const void* hs1,
                         const void* cs0, const void* cs1,
                         const void* dhs0, const void* dhs1,
                         void* dz0, void* dz1, void* barrier,
                         int T, int B, int H, int d0, int ndirs, int rev_mask,
                         int device, void* stream) {
  using TL = GroupTiling<G>;
  const int slices = (H + TL::JS - 1) / TL::JS;
  const size_t smem = smem_bytes<G>(B, H);
  const void* kernel = reinterpret_cast<const void*>(lstm_bwd_kernel<BM, G>);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm(kernel, device, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (ndirs * G * slices > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;

  typedef __nv_bfloat16 bf;
  const size_t H4 = 4 * (size_t)H;
  const int ld = BM ? T : B;
  for (int b0 = 0; b0 < B; b0 += TL::LAUNCH_ROWS) {
    // The batch slice [b0, b0 + nb): its first row, at t = 0.
    const size_t r0 = BM ? (size_t)b0 * T : (size_t)b0;
    const bf* a_xp0 = static_cast<const bf*>(xp0) + r0 * H4;
    const bf* a_xp1 = static_cast<const bf*>(xp1) + r0 * H4;
    const bf* a_U0 = static_cast<const bf*>(U0);
    const bf* a_U1 = static_cast<const bf*>(U1);
    const bf* a_hs0 = static_cast<const bf*>(hs0) + r0 * H;
    const bf* a_hs1 = static_cast<const bf*>(hs1) + r0 * H;
    const bf* a_cs0 = static_cast<const bf*>(cs0) + r0 * H;
    const bf* a_cs1 = static_cast<const bf*>(cs1) + r0 * H;
    const bf* a_dhs0 = static_cast<const bf*>(dhs0) + r0 * H;
    const bf* a_dhs1 = static_cast<const bf*>(dhs1) + r0 * H;
    bf* a_dz0 = static_cast<bf*>(dz0) + r0 * H4;
    bf* a_dz1 = static_cast<bf*>(dz1) + r0 * H4;
    unsigned int* a_bar =
        static_cast<unsigned int*>(barrier) + (b0 / TL::LAUNCH_ROWS) * 2 * G * BAR_STRIDE;
    int a_T = T, a_B = B - b0 < TL::LAUNCH_ROWS ? B - b0 : TL::LAUNCH_ROWS, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask, a_grows = group_rows<G>(a_B);
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1,
                    &a_dhs0, &a_dhs1, &a_dz0, &a_dz1, &a_bar,
                    &a_T, &a_B, &a_ld, &a_H, &a_slices, &a_d0, &a_rev, &a_grows};
    err = cudaLaunchCooperativeKernel(kernel, dim3(ndirs * G * slices), dim3(THREADS), args,
                                      smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool BM>
cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                   const void* hs0, const void* hs1,
                   const void* cs0, const void* cs1,
                   const void* dhs0, const void* dhs1,
                   void* dz0, void* dz1, void* barrier,
                   int T, int B, int H, int d0, int ndirs, int rev_mask, int groups,
                   int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1) || H > MAX_H || barrier == nullptr ||
      (groups != 1 && groups != 2))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (groups == 1)
    return launch_tiled<BM, 1>(xp0, xp1, U0, U1, hs0, hs1, cs0, cs1, dhs0, dhs1, dz0, dz1,
                               barrier, T, B, H, d0, ndirs, rev_mask, device, stream);
  return launch_tiled<BM, 2>(xp0, xp1, U0, U1, hs0, hs1, cs0, cs1, dhs0, dhs1, dz0, dz1,
                             barrier, T, B, H, d0, ndirs, rev_mask, device, stream);
}

}  // namespace

extern "C" const char* bilstm_tm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a call at (B, H) in `groups` batch groups takes (0
// for another number of groups).
extern "C" size_t bilstm_tm_bwd_smem_bytes(int B, int H, int groups) {
  if (groups == 1) return smem_bytes<1>(B, H);
  if (groups == 2) return smem_bytes<2>(B, H);
  return 0;
}

// Words of the zeroed int32 scratch a call at batch B in `groups` batch
// groups takes as `barrier`: a counter per direction and group of each
// launch, each on its own line (0 for another number of groups).
extern "C" int bilstm_tm_bwd_barrier_words(int B, int groups) {
  return barrier_words(B, groups);
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); streams (T, B, H);
// dz0, dz1 (T, B, 4H); barrier: bilstm_tm_bwd_barrier_words(B, groups)
// zeroed int32 words.
extern "C" int bilstm_tm_bwd(const void* xp0, const void* xp1, const void* U,
                             const void* hs0, const void* hs1,
                             const void* cs0, const void* cs1,
                             const void* dhs0, const void* dhs1,
                             void* dz0, void* dz1, void* barrier,
                             int T, int B, int H, int groups, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, dhs0, dhs1, dz0, dz1, barrier,
                       T, B, H, 0, 2, 2, groups, device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs, dhs (T, B, H) as the
// forward of the same `reverse` stored them; dz (T, B, 4H).
extern "C" int lstm_tm_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                           const void* dhs, void* dz, void* barrier,
                           int T, int B, int H, int reverse, int groups, int device,
                           void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, dhs, dhs, dz, dz, barrier,
                       T, B, H, reverse, 1, 2, groups, device, stream);
}

// D in {1, 2} batch-major directions whose forward scans ran t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs, dhs (D, B, T, H) as lstm_scan_fwd
// stored them (and the h stream's cotangent); dz (D, B, T, 4H).
extern "C" int lstm_scan_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                             const void* dhs, void* dz, void* barrier,
                             int D, int T, int B, int H, int groups, int device, void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's streams
  return launch<true>(xp, static_cast<const bf*>(xp) + 4 * n,
                      U, static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H,
                      hs, static_cast<const bf*>(hs) + n, cs, static_cast<const bf*>(cs) + n,
                      dhs, static_cast<const bf*>(dhs) + n,
                      dz, static_cast<bf*>(dz) + 4 * n, barrier,
                      T, B, H, 0, D, 0, groups, device, stream);
}
