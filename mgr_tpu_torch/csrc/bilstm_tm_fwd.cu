// LSTM forward recurrences for Hopper (sm_90a): the time-major two-direction
// layer, one direction of it, and the batch-major scan of D directions.
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_tm_fwd_kernel
// (launched by _tm_fwd_call, reached through pallas_bilstm_tm from
// mgr_tpu/ops/lstm.py::bilstm_layer_tm). The entry lstm_tm_fwd runs ONE
// direction of it and replaces _tm1_fwd_kernel (launched by _tm1_fwd_call,
// reached through pallas_lstm_tm from bilstm_layer_tm_dirsharded, the
// direction-sharded tensor-parallel path): the same blocks, launched for
// one direction only (forward order, or reverse order with reverse = 1).
// The entry lstm_scan_fwd replaces _fwd_kernel (launched by
// _lstm_scan_fwd_call, reached through pallas_recurrent_scan from
// mgr_tpu/ops/lstm.py::_recurrent_scan, the batch-major bilstm_layer and
// lstm_layer): the same blocks on a batch-major layout, where every one of
// the D directions scans forward (the caller flipped direction 1's input).
// Same function:
//
//   for each direction d, step s = 0..T-1, t = s, or T-1-s where d scans in
//   reverse (direction 1 of the time-major layer):
//     z     = xp_d[t] + bf16(h_prev) . U_d          (f32 accumulation)
//     i,f,o = clamp(0.2 z + 0.5, 0, 1)  (Keras hard_sigmoid);  g = tanh z
//     c     = f c + i g ;  h = o tanh c              (f32 carries from 0)
//   h (and, when asked, c) is stored in bf16 at the original position t.
//
// Layouts (gate-blocked, gate order i, f, g, o; column g*H + j):
//   time-major:  xp0, xp1 (T, B, 4H) bf16;  U (2, H, 4H);  hs*, cs* (T, B, H).
//   batch-major: xp (D, B, T, 4H) bf16;  U (D, H, 4H);  hs, cs (D, B, T, H).
// The kernel is one template over the layout: row (t, b) of a stream is
// t * ld + b time-major (ld = the batch) and b * ld + t batch-major (ld = T),
// so the batch-major projection is read and the h stream written in place.
//
// What bounds it on this card: latency, not bytes or operations. The
// recurrence is serial in t and every unit of step t needs all of h_{t-1};
// a step's product is (B,H)x(H,4H) per direction (8 MFLOP at B=32, H=500),
// microseconds of work spread over the card, followed by a dependency on
// every other block of the direction. A step costs the gather of h_{t-1}
// from L2, a short chain of tensor-core products, a reduction through
// shared memory, the gate math and the barrier. On an H100 at T=1900,
// H=500, B=128, with one 8-unit slice a block over all rows, a step took
// 11.2 us: 5.8 of them the h loads, one L2 round trip a 32-row tile in
// series behind the tile before (each tile's reduction and gate math sit
// between two __syncthreads), ~1.9 the products, ~1.7 the barrier wait.
// An SM gathers h at ~14 bytes a cycle from L2, whatever copies it.
//
// Design: ONE cooperative launch runs all T steps. The grid is directions
// x G batch groups x unit slices (lstm_common.cuh's GroupTiling): a block
// owns JS hidden units of one direction for the rows of one group, so the
// gate math needs no exchange, and keeps its c carries in registers, one
// thread per (row, unit) of a gate tile. h_{t-1} is exchanged through the
// bf16 h stream itself, the kernel's output. The tiling is a template
// argument, G:
//   - G = 1: JS = 8 over all rows of the launch (at most MAX_B = 256; gate
//     tiles of 32 rows). Each warp reads its K slice of h_{t-1} straight
//     into A fragments with 8-byte L2 loads (.cg: other blocks wrote it
//     during the launch, and L1 is not coherent), a tile at a time. The
//     per-step floor at small B.
//   - G = 2: JS = 16 (two n8 tiles a gate) over two groups of at most 64
//     rows (128 a launch; gate tiles of 16 rows). A block gathers its
//     group's rows only, half of G = 1's bytes at B=128, and in one round:
//     right after the barrier wait, warp 0 has the TMA unit copy them into
//     shared memory, a bulk copy and an mbarrier a gate tile (time-major, a
//     tile's rows are one run in the h stream; batch-major, a copy a row),
//     so the warps take each tile's products as its rows land, with no
//     load in their own instruction streams. The partial sums go to a red
//     buffer a tile, as [unit][gate] quads; one __syncthreads, then the
//     gate math of every tile. At H = 500 or 512 the grid is 2 x 32 x 2 =
//     128 blocks, one an SM. On the same card 12.2 ms at B=128 (21.1 in
//     one group), 7.5 at B=64 (12.1).
//   The wrapper (kernels/bilstm_tm.py::batch_groups, K2's rule too) chooses
//   G from B, H, the direction count and the SM count; the host entry
//   refuses a grid that cannot be co-resident, which the spin barrier
//   needs.
//   - The step product runs on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 sums; lstm_common.cuh): z[rows, 4 JS] = h_{t-1} . U_d[:,
//     slice]. The K axis (H, padded to k16 steps with zeros in both
//     operands) is split over the 8 warps, 4 k16 steps each (H <= 512), so
//     every warp works at every B; the partial sums meet in shared memory
//     and are added in warp order. The partition and the order depend only
//     on H, never on the tiling or the rows: both tilings, the two-
//     direction launch, one direction (lstm_tm_fwd) and the batch-major
//     scan give bit-equal h and c for a row, and two launches give
//     identical bits.
//   - U_d's slice stays in registers as bf16 B fragments for the whole
//     sequence (32 registers a thread in one group, 64 in two).
//   - A split barrier per (direction, group) replaces the grid-wide one: a
//     block ARRIVES on its counter after its h stores and WAITS on it
//     before reading h_{t-1}; directions and groups never wait on each
//     other. The next step's xp columns of the block's rows are copied
//     into shared memory with cp.async between arrive and wait (G = 1), or
//     a step ahead into a ring of two (G = 2), so no other load is left on
//     the serial path. The counters live in a scratch tensor the wrapper
//     zeroes for each call (bilstm_tm_fwd_barrier_words).
// The host entry runs a larger batch as consecutive launches over slices
// of rows. Shared memory: G = 1, 40 KB of partial sums + 64 B of xp a row
// (57 KB at 256 rows); G = 2, a red buffer of 34,816 bytes a gate tile
// (139,264), the staged rows 64 x 1,056 (67,584), the xp ring 16,384 and
// 4 mbarriers: 223,264 bytes at H = 500 and 512.
// What it leaves: the gather's bytes (G = 2 at B=128: 8 MB of L2 reads a
// step, each group's 64 KB of h read by its 32 blocks; a cluster could
// share them by TMA multicast or distributed shared memory, but a cluster
// launch that is also cooperative has not been tried on this card); the
// reduction's shared-memory traffic (128 KB written and read a step at
// B=128, fixed by the K split); wgmma (M is the batch, at most 64 rows a
// block, and a step issues 32 mma a warp and tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

// The two-group tiling stages the group's h_{t-1} rows in shared memory,
// hp bytes a row: a gate tile's 16 rows in 16 hp bytes. The h stream is
// written by other blocks during the launch, so the rows are copied by the
// TMA unit (bulk copies, which read at L2), and a bulk copy moves a
// 16-byte-aligned run: the run that covers the rows, from the 16-byte
// boundary at or below the first. Time-major, a tile's rows are one run in
// the h stream (rows 2H bytes apart from 0, 4, 8 or 12 bytes into the
// tile's slot); batch-major, each row is a run of its own, in a slot of hp
// bytes.
__host__ __device__ inline int h_slot_bytes(int H) {
  return 4 * pad_words(4 * ((2 * H + 12 + 15) / 16));
}

// The two-group tiling's partial z sums, a warp's row of 16 units x 4 gates
// as quads [unit][gate], so that a thread reads its (row, unit)'s four
// gates of a warp in one 16-byte load: [WARPS][16 rows][QUAD_PITCH] f32.
// The row pitch, 4 mod 32 words, keeps the fragment stores (two rows of
// four lanes a quarter warp) and the quad loads free of bank conflicts.
constexpr int QUAD_PITCH = 4 * 16 + 4;
constexpr int RED_QUADS = WARPS * 16 * QUAD_PITCH;  // floats a buffer

__device__ __forceinline__ void store_z_quads(float* red, const float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  float* base = red + warp * 16 * QUAD_PITCH;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g8 + 8 * (e >> 1), unit = 8 * n + 2 * c4 + (e & 1);
      *reinterpret_cast<float4*>(base + row * QUAD_PITCH + unit * 4) =
          make_float4(acc[n][0][e], acc[n][1][e], acc[n][2][e], acc[n][3][e]);
    }
}

// The four gates' z products at (tile row r, unit j): the warps' partial
// sums added in warp order, as z_sum adds them (so the bits are K1's of
// one group).
__device__ __forceinline__ float4 z_quad_sum(const float* red, int r, int j) {
  const float* p = red + r * QUAD_PITCH + j * 4;
  float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const float4 q = *reinterpret_cast<const float4*>(p + w * 16 * QUAD_PITCH);
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  return s;
}

// Dynamic shared memory of the two-group tiling at width H: a red buffer
// of partial sums a gate tile [MAX_TILES][RED_QUADS] f32 | the staged h
// rows [MAX_ROWS][hp] | the xp ring [2][MAX_ROWS][4 gates][JS] bf16 | an
// mbarrier a gate tile.
__host__ __device__ inline size_t two_group_smem(int H) {
  using TL = GroupTiling<2>;
  return TL::MAX_TILES * sizeof(float) * RED_QUADS +
         (size_t)TL::MAX_ROWS * h_slot_bytes(H) + (size_t)2 * TL::MAX_ROWS * 4 * TL::JS * 2 +
         (size_t)8 * TL::MAX_TILES;
}

template <bool BM, int G>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const __nv_bfloat16* __restrict__ xp0,
                const __nv_bfloat16* __restrict__ xp1,
                const __nv_bfloat16* __restrict__ U0,
                const __nv_bfloat16* __restrict__ U1,
                __nv_bfloat16* hs0, __nv_bfloat16* hs1,
                __nv_bfloat16* cs0, __nv_bfloat16* cs1, unsigned int* barrier,
                int T, int B, int ld, int H, int slices, int d0, int rev_mask, int grows) {
  // B <= GroupTiling<G>::LAUNCH_ROWS rows of a batch laid out as row_at<BM>,
  // in groups of grows rows. Block (dl, group, slice) at blockIdx.x = (dl *
  // G + group) * slices + slice; the grid covers directions d0 .. d0 +
  // gridDim.x / (G * slices) - 1; direction d scans in reverse where bit d
  // of rev_mask is set.
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (G == 1) {
    const int dl = blockIdx.x / slices;  // direction within the launch
    const int d = d0 + dl;
    const bool rev = (rev_mask >> d) & 1;
    const int j0 = (blockIdx.x % slices) * JS;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int gr = tid / JS, gj = tid % JS;  // this thread's (tile row, unit) of the gate math
    const int unit = j0 + gj;
    const bool unit_ok = unit < H;
    const size_t H4 = 4 * (size_t)H;
    const int tiles = (B + RT - 1) / RT;
    unsigned int* ctr = barrier + dl * BAR_STRIDE;

    // Shared memory: red [WARPS][RT][RED_PITCH] f32 | xp_s [B][4 gates][JS] bf16.
    float* red = reinterpret_cast<float*>(smem);
    __nv_bfloat16* xp_s = reinterpret_cast<__nv_bfloat16*>(smem + sizeof(float) * RED_Z_FLOATS);

    const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
    const __nv_bfloat16* xp = d == 0 ? xp0 : xp1;
    __nv_bfloat16* hs = d == 0 ? hs0 : hs1;
    __nv_bfloat16* cs = d == 0 ? cs0 : cs1;

    uint2 ub[KPW][4];  // this warp's K slice of U_d[:, slice], resident all sequence
#pragma unroll
    for (int i = 0; i < KPW; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) ub[i][g] = u_col_frag(Ud, warp * KPW + i, g, j0, lane, H);

    float c_reg[MAX_TILES];  // c of row tile * RT + gr, unit j0 + gj
#pragma unroll
    for (int tile = 0; tile < MAX_TILES; ++tile) c_reg[tile] = 0.0f;

    // xp_d[t] of this block's 32 columns, all B rows, into xp_s: one 4-byte
    // copy per unit pair (xp is never written during the launch).
    auto prefetch_xp = [&](int t) {
      for (int q = tid; q < B * 16; q += THREADS) {
        const int b = q >> 4, g = (q >> 2) & 3, p = q & 3;
        if (j0 + 2 * p < H)
          cp_async4(xp_s + (b * 4 + g) * JS + 2 * p,
                    xp + row_at<BM>(t, b, ld) * H4 + (size_t)g * H + j0 + 2 * p);
      }
      cp_async_commit();
    };

    prefetch_xp(rev ? T - 1 : 0);
    for (int s = 0; s < T; ++s) {
      const int t = rev ? T - 1 - s : s;
      const int t_prev = rev ? t + 1 : t - 1;
      if (s > 0) barrier_wait(ctr, (unsigned int)(s * slices));  // h_{t-1} is in the h stream
      cp_async_wait<0>();  // this step's xp (made visible by the __syncthreads below)
#pragma unroll
      for (int tile = 0; tile < MAX_TILES; ++tile) {
        if (tile >= tiles) break;  // uniform over the block
        const int b0 = tile * RT;
        if (s > 0) {  // h_{-1} = 0: step 0 is z = xp alone
          if (tile > 0) __syncthreads();  // the previous tile's readers are done with red
          float acc[2][4][4];
          z_partial<BM>(hs, t_prev, b0, B, ld, H,
                        [&](int i, int g) { return ub[i][g]; }, acc);
          store_z_partial(red, acc);
        }
        __syncthreads();
        const int b = b0 + gr;
        if (unit_ok && b < B) {
          float z[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float x = __bfloat162float(xp_s[(b * 4 + g) * JS + gj]);
            z[g] = s > 0 ? x + z_sum(red, gr, g, gj) : x;
          }
          const float ig = hard_sigmoid(z[0]);
          const float fg = hard_sigmoid(z[1]);
          const float gg = tanhf(z[2]);
          const float og = hard_sigmoid(z[3]);
          const float c = __fadd_rn(__fmul_rn(fg, c_reg[tile]), __fmul_rn(ig, gg));
          c_reg[tile] = c;
          const size_t out = row_at<BM>(t, b, ld) * H + unit;
          hs[out] = __float2bfloat16_rn(__fmul_rn(og, tanhf(c)));
          if (cs != nullptr) cs[out] = __float2bfloat16_rn(c);
        }
      }
      if (s + 1 < T) {
        __syncthreads();  // the step's h stores are done, and every read of xp_s
        barrier_arrive(ctr);
        prefetch_xp(rev ? t - 1 : t + 1);
      }
    }

  } else {
    using TL = GroupTiling<G>;
    constexpr int JS_ = TL::JS, RT_ = TL::RT, NT = TL::NT;
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
    const int gr = tid / JS_, gj = tid % JS_;  // this thread's (tile row, unit) of the gate math
    const int unit = j0 + gj;
    const bool unit_ok = unit < H;
    const size_t H4 = 4 * (size_t)H;
    const int tiles = (Bg + RT_ - 1) / RT_;
    unsigned int* ctr = barrier + (dl * G + grp) * BAR_STRIDE;

    // Shared memory: see two_group_smem.
    constexpr int RED = RED_QUADS;  // floats a red buffer
    float* red = reinterpret_cast<float*>(smem);
    unsigned char* hst = smem + TL::MAX_TILES * sizeof(float) * RED;
    const int hp = h_slot_bytes(H);
    __nv_bfloat16* xp_ring = reinterpret_cast<__nv_bfloat16*>(hst + (size_t)TL::MAX_ROWS * hp);
    uint64_t* hbar = reinterpret_cast<uint64_t*>(xp_ring + 2 * TL::MAX_ROWS * 4 * JS_);
    if (tid == 0)
      for (int k = 0; k < TL::MAX_TILES; ++k) mbar_init(hbar + k, 1);

    const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
    const __nv_bfloat16* xp = (d == 0 ? xp0 : xp1) + r0 * H4;
    __nv_bfloat16* hs = (d == 0 ? hs0 : hs1) + r0 * H;
    __nv_bfloat16* cs = d == 0 ? cs0 : cs1;
    if (cs != nullptr) cs += r0 * H;

    // This warp's K slice of U_d[:, slice] as B fragments, resident all
    // sequence: n8 tile c = g * NT + n holds gate g's units j0 + 8n ...
    uint2 ub[KPW][4 * NT];
#pragma unroll
    for (int i = 0; i < KPW; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NT; ++c)
        ub[i][c] = u_col_frag(Ud, warp * KPW + i, c / NT, j0 + 8 * (c % NT), lane, H);

    float c_reg[TL::MAX_TILES];  // c of row tile * RT + gr, unit j0 + gj
#pragma unroll
    for (int tile = 0; tile < TL::MAX_TILES; ++tile) c_reg[tile] = 0.0f;

    // xp_d[t] of this block's 4 JS_ columns, the group's rows, into ring
    // buffer buf: 8-byte copies where 4 | H (4 units; xp is never written
    // during the launch, so through L1), else 4-byte ones.
    const int xw = (H & 3) == 0 ? 4 : 2;  // units a copy
    const int xq = JS_ / xw;               // copies a gate and row
    auto prefetch_xp = [&](int t, int buf) {
      __nv_bfloat16* dst = xp_ring + (size_t)buf * TL::MAX_ROWS * 4 * JS_;
      for (int q = tid; q < Bg * 4 * xq; q += THREADS) {
        const int b = q / (4 * xq), g = (q / xq) & 3, u = (q % xq) * xw;
        if (j0 + u < H) {
          const __nv_bfloat16* src = xp + row_at<BM>(t, b, ld) * H4 + (size_t)g * H + j0 + u;
          if (xw == 4) cp_async8(dst + (b * 4 + g) * JS_ + u, src);
          else cp_async4(dst + (b * 4 + g) * JS_ + u, src);
        }
      }
      cp_async_commit();
    };
    // The group's h_{t_prev} rows into shared memory, issued by warp 0's
    // lanes, each gate tile's rows completing on an mbarrier of its own: the
    // warps take a tile's products as soon as its rows land, while the TMA
    // unit moves the next tiles'. Time-major, lane k copies tile k's run;
    // batch-major, lane l copies rows l and l + 32, and lane k states tile
    // k's bytes.
    auto h_addr = [&](int t_prev, int r) {
      return reinterpret_cast<uintptr_t>(hs + row_at<BM>(t_prev, r, ld) * H);
    };
    auto run = [&](uintptr_t a, int rows) {  // bytes of the run that covers `rows` rows from a
      return (uint32_t)((a & 15) + (size_t)rows * 2 * H + 15) & ~15u;
    };
    const int tslot = RT_ * hp;  // bytes a tile
    auto stage_h = [&](int t_prev) {
      // Other blocks' generic stores wrote the rows (acquired by the barrier
      // wait), and the bulk copies read them through the async proxy.
      asm volatile("fence.proxy.async;\n" ::: "memory");
      const int k = lane, rows = min(RT_, Bg - k * RT_);  // lane k's tile
      if (!BM) {
        if (k < tiles) {
          const uintptr_t a = h_addr(t_prev, k * RT_);
          mbar_arrive_expect_tx(hbar + k, run(a, rows));
          bulk_copy(hst + k * tslot, reinterpret_cast<const void*>(a & ~uintptr_t(15)),
                    run(a, rows), hbar + k);
        }
        return;
      }
      for (int r = lane; r < Bg; r += 32) {
        const uintptr_t a = h_addr(t_prev, r);
        bulk_copy(hst + r * hp, reinterpret_cast<const void*>(a & ~uintptr_t(15)), run(a, 1),
                  hbar + r / RT_);
      }
      if (k < tiles) {
        uint32_t bytes = 0;
        for (int r = k * RT_; r < k * RT_ + rows; ++r) bytes += run(h_addr(t_prev, r), 1);
        mbar_arrive_expect_tx(hbar + k, bytes);
      }
    };
    // Staged row r.
    auto h_frag = [&](int t_prev, int r) {
      const int m = r % RT_;
      return BM ? hst + r * hp + (int)(h_addr(t_prev, r) & 15)
                : hst + (r - m) / RT_ * tslot + (int)(h_addr(t_prev, r - m) & 15) + m * 2 * H;
    };

    // The gate math of a tile: z = xp + the partial sums in the tile's red
    // buffer, added in warp order (xp alone at step 0); c and h.
    auto gates = [&](int s, int t, int tile, const __nv_bfloat16* xp_s) {
      const int b = tile * RT_ + gr;
      if (!unit_ok || b >= Bg) return;
      const float* rz = red + tile * RED;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = __bfloat162float(xp_s[(b * 4 + g) * JS_ + gj]);
      if (s > 0) {
        const float4 q = z_quad_sum(rz, gr, gj);
        z[0] += q.x;
        z[1] += q.y;
        z[2] += q.z;
        z[3] += q.w;
      }
      const float ig = hard_sigmoid(z[0]);
      const float fg = hard_sigmoid(z[1]);
      const float gg = tanhf(z[2]);
      const float og = hard_sigmoid(z[3]);
      const float c = __fadd_rn(__fmul_rn(fg, c_reg[tile]), __fmul_rn(ig, gg));
      c_reg[tile] = c;
      const size_t out = row_at<BM>(t, b, ld) * H + unit;
      hs[out] = __float2bfloat16_rn(__fmul_rn(og, tanhf(c)));
      if (cs != nullptr) cs[out] = __float2bfloat16_rn(c);
    };
    // This warp's partial z of a tile, from the staged rows of h_{t_prev}.
    auto products = [&](int t_prev, int tile, float (&acc)[2][4][4]) {
      z_partial_staged<JS_>(
          [&](int r, int k) {
            const unsigned char* p = h_frag(t_prev, r) + 2 * k;
            if ((H & 3) == 0) return *reinterpret_cast<const uint2*>(p);
            return make_uint2(*reinterpret_cast<const unsigned int*>(p),
                              *reinterpret_cast<const unsigned int*>(p + 4));
          },
          tile * RT_, Bg, H, [&](int i, int c) { return ub[i][c]; }, acc);
    };

    prefetch_xp(rev ? T - 1 : 0, 0);
    for (int s = 0; s < T; ++s) {
      const int t = rev ? T - 1 - s : s;
      const int t_prev = rev ? t + 1 : t - 1;
      const bool more = s + 1 < T;
      if (s > 0) {
        barrier_wait(ctr, (unsigned int)(s * slices));  // h_{t-1} is in the h stream
        if (warp == 0) stage_h(t_prev);
      }
      // The next step's xp, a step ahead, and this step's (committed a
      // step ago), landed for this thread; the __syncthreads after the
      // products shows it to every thread.
      if (more) prefetch_xp(rev ? t - 1 : t + 1, (s + 1) & 1);
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
      const __nv_bfloat16* xp_s = xp_ring + (size_t)(s & 1) * TL::MAX_ROWS * 4 * JS_;
      const uint32_t parity = (s - 1) & 1;  // the tiles' mbarriers complete once a step from s = 1
      if (s > 0) {
        // Each tile's products as its rows land, into a red buffer of its
        // own; then one __syncthreads, and the gate math of every tile.
#pragma unroll
        for (int tile = 0; tile < TL::MAX_TILES; ++tile) {
          if (tile >= tiles) break;  // uniform over the block
          float acc[2][4][4];
          mbar_wait(hbar + tile, parity);
          products(t_prev, tile, acc);
          store_z_quads(red + tile * RED, acc);
        }
      }
      __syncthreads();
#pragma unroll
      for (int tile = 0; tile < TL::MAX_TILES; ++tile)
        if (tile < tiles) gates(s, t, tile, xp_s);
      if (more) {
        __syncthreads();  // the step's h stores are done, and every read of the slots and xp_s
        barrier_arrive(ctr);
      }
    }
  }
}

}  // namespace

extern "C" const char* bilstm_tm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a call at (B, H) in `groups` batch groups takes (0
// for another number of groups).
extern "C" size_t bilstm_tm_fwd_smem_bytes(int B, int H, int groups) {
  if (groups == 2) return two_group_smem(H);
  if (groups != 1) return 0;
  const size_t rows = (size_t)(B < MAX_B ? B : MAX_B);
  return sizeof(float) * RED_Z_FLOATS + round16(rows * 4 * JS * 2);
}

// Words of the zeroed int32 scratch a call at batch B in `groups` batch
// groups takes as `barrier` (0 for another number of groups).
extern "C" int bilstm_tm_fwd_barrier_words(int B, int groups) {
  return barrier_words(B, groups);
}

// Runs directions d0 .. d0 + ndirs - 1 of the recurrence on `stream` in G
// batch groups, as one cooperative launch per LAUNCH_ROWS batch rows, each
// on its own counters in `barrier`. cs0/cs1 may be null (the c stream is
// only needed by the backward kernel). Returns the first cudaError_t: a grid
// that cannot be co-resident is refused, never run.
template <bool BM, int G>
static cudaError_t launch_tiled(const void* xp0, const void* xp1, const void* U0,
                                const void* U1, void* hs0, void* hs1, void* cs0, void* cs1,
                                void* barrier, int T, int B, int H, int d0, int ndirs,
                                int rev_mask, int device, void* stream) {
  using TL = GroupTiling<G>;
  const int slices = (H + TL::JS - 1) / TL::JS;
  const size_t smem = bilstm_tm_fwd_smem_bytes(B, H, G);
  const void* kernel = reinterpret_cast<const void*>(lstm_fwd_kernel<BM, G>);
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
    bf* a_hs0 = static_cast<bf*>(hs0) + r0 * H;
    bf* a_hs1 = static_cast<bf*>(hs1) + r0 * H;
    bf* a_cs0 = cs0 ? static_cast<bf*>(cs0) + r0 * H : nullptr;
    bf* a_cs1 = cs1 ? static_cast<bf*>(cs1) + r0 * H : nullptr;
    unsigned int* a_bar =
        static_cast<unsigned int*>(barrier) + (b0 / TL::LAUNCH_ROWS) * 2 * G * BAR_STRIDE;
    int a_T = T, a_B = B - b0 < TL::LAUNCH_ROWS ? B - b0 : TL::LAUNCH_ROWS, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask, a_grows = group_rows<G>(a_B);
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1, &a_bar,
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
static cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                          void* hs0, void* hs1, void* cs0, void* cs1, void* barrier,
                          int T, int B, int H, int d0, int ndirs, int rev_mask, int groups,
                          int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1) || H > MAX_H || barrier == nullptr ||
      (groups != 1 && groups != 2))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (groups == 1)
    return launch_tiled<BM, 1>(xp0, xp1, U0, U1, hs0, hs1, cs0, cs1, barrier, T, B, H, d0,
                               ndirs, rev_mask, device, stream);
  return launch_tiled<BM, 2>(xp0, xp1, U0, U1, hs0, hs1, cs0, cs1, barrier, T, B, H, d0,
                             ndirs, rev_mask, device, stream);
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); direction 1 scans
// T-1 -> 0; barrier: bilstm_tm_fwd_barrier_words(B, groups) zeroed int32
// words.
extern "C" int bilstm_tm_fwd(const void* xp0, const void* xp1, const void* U,
                             void* hs0, void* hs1, void* cs0, void* cs1, void* barrier,
                             int T, int B, int H, int groups, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, barrier, T, B, H, 0, 2, 2, groups,
                       device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs (T, B, H), cs may be
// null; reverse = 1 scans T-1 -> 0. Outputs at original time positions.
extern "C" int lstm_tm_fwd(const void* xp, const void* U, void* hs, void* cs, void* barrier,
                           int T, int B, int H, int reverse, int groups, int device,
                           void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, barrier, T, B, H, reverse, 1, 2, groups,
                       device, stream);
}

// D in {1, 2} batch-major directions, each scanning t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs (D, B, T, H), cs may be null.
extern "C" int lstm_scan_fwd(const void* xp, const void* U, void* hs, void* cs, void* barrier,
                             int D, int T, int B, int H, int groups, int device,
                             void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's h stream
  const bf* xp1 = static_cast<const bf*>(xp) + 4 * n;
  const bf* U1 = static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H;
  bf* hs1 = static_cast<bf*>(hs) + n;
  bf* cs1 = cs ? static_cast<bf*>(cs) + n : nullptr;
  return launch<true>(xp, xp1, U, U1, hs, hs1, cs, cs1, barrier, T, B, H, 0, D, 0, groups,
                      device, stream);
}
