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
// What bounds it on this card: latency. The walk is serial in t and every
// unit of a step needs the dz of all units of the step before (dh_carry
// sums over all 4H columns), so each block gathers the whole dz row set of
// the last step from L2 (B x 8H bytes: 128 KB at B=32, H=500) every step.
// Per step and direction there are two (B,H)x(H,4H)-sized products, the z
// recompute and the dh_carry product, then a dependency on every other
// block of the direction.
//
// Design: ONE cooperative launch runs all T steps. Each block owns JS = 8
// hidden units of one direction; a thread owns a (batch row, unit) of a
// 32-row tile and keeps its dc carry in registers. The only exchange is
// dz, through the kernel's own bf16 output.
//   - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 sums; lstm_common.cuh), K split over the 8 warps with partial
//     sums added in warp order through shared memory: the z recompute as
//     in bilstm_tm_fwd.cu (K = H), and dh_carry = bf16(dz_{t_last}) .
//     U_d[slice, :]^T with K = the flat 4H axis (125 k16 steps at H=500, 16
//     a warp). The partition depends only on H, so the two-direction
//     launch, one direction (lstm_tm_bwd) and the batch-major walk give
//     bit-equal dz, and two launches give identical bits.
//   - U_d resident in bf16: the dh_carry operand (U_d's 8 rows, 16 k16
//     steps a warp) in registers, 32 a thread; the z operand (U_d's 32
//     columns) in shared memory as B fragments, 32 KB.
//   - The z recompute is off the serial path. z_t needs only the streams
//     the forward stored (xp_t, h_{t_pre}), as the TPU kernel's
//     direction_step does, so right after arriving at step s's barrier a
//     block recomputes step s+1's z and everything that does not depend
//     on the walk: the gates, tanh c_t, c_{t_pre}, dhs[t] (read there,
//     ahead of the z product), folded into 7 floats per (row, unit) in
//     shared memory. After the wait only the dependent part is left: the
//     dz gather, the dh_carry products, 3 multiply-adds per gate and the
//     dz store.
//   - The dz gather: rows are 8H bytes (16-byte aligned), so each m16 row
//     tile of dz_{t_last} is staged whole with 16-byte cp.async.cg copies
//     (L2 only: other blocks wrote it during the launch) through a ring of
//     two buffers, so tile m+1 (and m+2's issue) overlaps tile m's
//     products. The smem row pitch is padded to 8 mod 32 words, which
//     makes the fragment reads free of bank conflicts.
//   - A per-direction split barrier as in bilstm_tm_fwd.cu.
// Shared memory budget (bytes, H=500; at most 232,448 a block): U_d's
// z fragments 32,768; the dz ring 2 x 16 x 4000 = 128,000 (the z partial
// sums, 40,960, reuse it between arrive and wait); dh partial sums 8,192;
// the step's folded values 7 x 4 x 8 x min(B, 256): 57,344 at 256 rows.
// 226,304 at B=256, H=500; 230,400 at B=256, H=512 (MAX_H).
// A launch covers at most MAX_B = 256 rows; the host entry runs a larger
// batch as consecutive launches over slices of rows. At H=500 the grid is
// 2 x 63 = 126 blocks, one per SM.
// What it leaves: wgmma (M is the batch: 32 rows at the train batch); a
// cluster / distributed-shared-memory exchange of dz in place of the L2
// gather (a direction's 63 blocks exceed a cluster); K6's layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

constexpr int KPW_DH = 16;     // k16 steps per warp of the dh_carry product (4H <= 2048)
constexpr int NPREP = 7;       // folded values per (row, unit)
constexpr int RED_DH_FLOATS = WARPS * RT * JS;

// Row pitch of the dz ring in 32-bit words: the row's 2H words, padded to
// 8 mod 32 (a multiple of 4 words, so 16-byte aligned).
__host__ __device__ inline int ring_pitch_words(int H) {
  const int w = 2 * H;
  return w + (((8 - w) % 32) + 32) % 32;
}

__host__ __device__ inline size_t ring_bytes(int H) {
  const size_t ring = (size_t)2 * 16 * ring_pitch_words(H) * 4;
  const size_t red = sizeof(float) * RED_Z_FLOATS;
  return round16(ring > red ? ring : red);
}

template <bool BM>
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
                int T, int B, int ld, int H, int slices, int d0, int rev_mask) {
  // B <= MAX_B rows of a batch laid out as row_at<BM>. The grid covers
  // directions d0 .. d0 + gridDim.x / slices - 1; direction d's forward
  // scan ran in reverse where bit d of rev_mask is set.
  extern __shared__ __align__(16) unsigned char smem[];
  const int dl = blockIdx.x / slices;  // direction within the launch
  const int d = d0 + dl;
  const bool rev = (rev_mask >> d) & 1;
  const int j0 = (blockIdx.x % slices) * JS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int gr = tid / JS, gj = tid % JS;  // this thread's (tile row, unit) of the gate math
  const int unit = j0 + gj;
  const bool unit_ok = unit < H;
  const size_t H4 = 4 * (size_t)H;
  const int H4i = 4 * H;
  const int tiles = (B + RT - 1) / RT;
  const int mtiles = (B + 15) / 16;
  const int KS = (H + 15) >> 4;          // k16 steps of the z product
  const int KS_DH = (H4i + 15) >> 4;     // k16 steps of the dh_carry product
  const int pitch = 4 * ring_pitch_words(H);  // bytes
  const int prep_n = B * JS;                  // folded values per kind
  unsigned int* ctr = barrier + dl * BAR_STRIDE;

  // Shared memory: uz_s [KS][4 gates][32 lanes] uint2 | ring (2 x 16 rows x
  // pitch, or red_z [WARPS][RT][RED_PITCH] f32 between arrive and wait) |
  // red_dh [WARPS][RT][JS] f32 | prep [NPREP][B][JS] f32.
  uint2* uz_s = reinterpret_cast<uint2*>(smem);
  unsigned char* ring = smem + (size_t)KS * 4 * 32 * sizeof(uint2);
  float* red_z = reinterpret_cast<float*>(ring);
  float* red_dh = reinterpret_cast<float*>(ring + ring_bytes(H));
  float* prep = red_dh + RED_DH_FLOATS;

  const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
  const __nv_bfloat16* xp = d == 0 ? xp0 : xp1;
  const __nv_bfloat16* hs = d == 0 ? hs0 : hs1;
  const __nv_bfloat16* cs = d == 0 ? cs0 : cs1;
  const __nv_bfloat16* dhs = d == 0 ? dhs0 : dhs1;
  __nv_bfloat16* dz = d == 0 ? dz0 : dz1;

  for (int e = tid; e < KS * 4 * 32; e += THREADS)
    uz_s[e] = u_col_frag(Ud, e >> 7, (e >> 5) & 3, j0, e & 31, H);
  // dh_carry's B fragments: U_d[u, k .. k+3] with u = j0 + g8 (a row of
  // U_d, 8H bytes: an 8-byte load), zero past H or 4H.
  uint2 ubd[KPW_DH];
#pragma unroll
  for (int i = 0; i < KPW_DH; ++i) {
    const int u = j0 + g8, k = (warp * KPW_DH + i) * 16 + 4 * c4;
    ubd[i] = (u < H && k < H4i) ? *reinterpret_cast<const uint2*>(Ud + (size_t)u * H4 + k)
                                : make_uint2(0u, 0u);
  }
  __syncthreads();

  float dc_reg[MAX_TILES];  // dc carry of row tile * RT + gr, unit j0 + gj
#pragma unroll
  for (int tile = 0; tile < MAX_TILES; ++tile) dc_reg[tile] = 0.0f;

  // Step s's z recompute and the values that do not depend on the walk,
  // folded per (row, unit) into prep. Between arrive and wait (and once
  // before the walk): the ring is free, and red_z lives there.
  auto precompute = [&](int s) {
    const int t = rev ? s : T - 1 - s;
    const int t_pre = rev ? t + 1 : t - 1;
    const bool has_pre = t_pre >= 0 && t_pre < T;
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * RT;
      const int b = b0 + gr;
      const bool mine = unit_ok && b < B;
      // This thread's operands, read ahead of the z product.
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ct = 0.0f, cp = 0.0f, dh_in = 0.0f;
      if (mine) {
        const size_t row = row_at<BM>(t, b, ld);
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = __bfloat162float(xp[row * H4 + (size_t)g * H + unit]);
        ct = __bfloat162float(cs[row * H + unit]);
        dh_in = __bfloat162float(dhs[row * H + unit]);
        if (has_pre) cp = __bfloat162float(cs[row_at<BM>(t_pre, b, ld) * H + unit]);
      }
      if (has_pre) {
        if (tile > 0) __syncthreads();  // the previous tile's readers are done with red_z
        float acc[2][4][4];
        z_partial<BM>(hs, t_pre, b0, B, ld, H,
                      [&](int i, int g) { return uz_s[((warp * KPW + i) * 4 + g) * 32 + lane]; },
                      acc);
        store_z_partial(red_z, acc);
        __syncthreads();
      }
      if (mine) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = has_pre ? x[g] + z_sum(red_z, gr, g, gj) : x[g];
        const float ig = hard_sigmoid(z[0]);
        const float fg = hard_sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float og = hard_sigmoid(z[3]);
        const float tc = tanhf(ct);
        float* p = prep + b * JS + gj;
        p[0 * prep_n] = dh_in;
        p[1 * prep_n] = og * (1.0f - tc * tc);                // dc += dh * this
        p[2 * prep_n] = hard_sigmoid_slope(z[0]) ? gg : 0.0f;  // dz_i = (dc * this) * 0.2
        p[3 * prep_n] = hard_sigmoid_slope(z[1]) ? cp : 0.0f;  // dz_f = (dc * this) * 0.2
        p[4 * prep_n] = ig * (1.0f - gg * gg);                // dz_g = dc * this
        p[5 * prep_n] = hard_sigmoid_slope(z[3]) ? tc : 0.0f;  // dz_o = (dh * this) * 0.2
        p[6 * prep_n] = fg;                                   // dc_carry = dc * this
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
      if (b < B) {
        const __nv_bfloat16* src = dz + row_at<BM>(t_last, b, ld) * H4;
        for (int q = lane; q < H / 2; q += 32) cp_async16(buf + r * pitch + 16 * q, src + 8 * q);
      }
    }
    cp_async_commit();
  };

  precompute(0);
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int t_last = rev ? t - 1 : t + 1;  // the step walked before this one
    if (s > 0) {
      barrier_wait(ctr, (unsigned int)(s * slices));  // dz_{t_last} is in the dz output
      stage_dz(t_last, 0);
      if (mtiles > 1) stage_dz(t_last, 1);
    }
#pragma unroll
    for (int tile = 0; tile < MAX_TILES; ++tile) {
      if (tile >= tiles) break;  // uniform over the block
      if (s > 0) {
        // dh_carry of the tile's two m16 tiles: bf16(dz_{t_last}) . U_d[slice, :]^T.
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int m = 2 * tile + h2;
          if (m >= mtiles) break;
          if (m + 1 < mtiles) cp_async_wait<1>(); else cp_async_wait<0>();
          __syncthreads();  // tile m landed for every warp (and red_dh's readers are done)
          const unsigned char* buf = ring + (size_t)(m & 1) * 16 * pitch;
          float acc0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < KPW_DH; ++i) {
            const int ks = warp * KPW_DH + i;
            if (ks >= KS_DH) break;  // uniform over the warp
            const int k = ks * 16 + 4 * c4;
            uint2 lo = *reinterpret_cast<const uint2*>(buf + g8 * pitch + 2 * k);
            uint2 hi = *reinterpret_cast<const uint2*>(buf + (g8 + 8) * pitch + 2 * k);
            if (k >= H4i) lo = hi = make_uint2(0u, 0u);  // past the row: the ring's padding
            if (i & 1)  // two chains of products, added at the end
              mma16816(acc1, lo.x, hi.x, lo.y, hi.y, ubd[i].x, ubd[i].y);
            else
              mma16816(acc0, lo.x, hi.x, lo.y, hi.y, ubd[i].x, ubd[i].y);
          }
          float* p = red_dh + (warp * RT + h2 * 16 + g8) * JS + 2 * c4;
          *reinterpret_cast<float2*>(p) = make_float2(acc0[0] + acc1[0], acc0[1] + acc1[1]);
          *reinterpret_cast<float2*>(p + 8 * JS) =
              make_float2(acc0[2] + acc1[2], acc0[3] + acc1[3]);
          __syncthreads();  // buffer m & 1 is free, and the partial sums are visible
          if (m + 2 < mtiles) stage_dz(t_last, m + 2);
        }
      }
      const int b = tile * RT + gr;
      if (unit_ok && b < B) {
        const float* p = prep + b * JS + gj;
        float dh = p[0];
        if (s > 0) {
          const float* q = red_dh + gr * JS + gj;
          float carry = q[0];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) carry += q[w * RT * JS];
          dh += carry;
        }
        const float dc = dc_reg[tile] + dh * p[1 * prep_n];
        const size_t row4 = row_at<BM>(t, b, ld) * H4 + unit;
        dz[row4] = __float2bfloat16_rn((dc * p[2 * prep_n]) * 0.2f);
        dz[row4 + (size_t)H] = __float2bfloat16_rn((dc * p[3 * prep_n]) * 0.2f);
        dz[row4 + 2 * (size_t)H] = __float2bfloat16_rn(dc * p[4 * prep_n]);
        dz[row4 + 3 * (size_t)H] = __float2bfloat16_rn((dh * p[5 * prep_n]) * 0.2f);
        dc_reg[tile] = dc * p[6 * prep_n];
      }
    }
    if (s + 1 < T) {
      __syncthreads();  // the step's dz stores are done, and every read of prep and the ring
      barrier_arrive(ctr);
      precompute(s + 1);
    }
  }
}

}  // namespace

extern "C" const char* bilstm_tm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory the kernel needs at this (B, H).
extern "C" size_t bilstm_tm_bwd_smem_bytes(int B, int H) {
  const size_t rows = (size_t)(B < MAX_B ? B : MAX_B);
  const size_t uz = (size_t)((H + 15) / 16) * 4 * 32 * sizeof(uint2);
  return uz + ring_bytes(H) + sizeof(float) * RED_DH_FLOATS +
         round16(sizeof(float) * NPREP * rows * JS);
}

// Words of the zeroed int32 scratch a call at batch B takes as `barrier`.
extern "C" int bilstm_tm_bwd_barrier_words(int B) { return barrier_words(B); }

// Runs the backward walk of directions d0 .. d0 + ndirs - 1 on `stream`, as
// one cooperative launch per MAX_B batch rows, each on its own counters in
// `barrier`. Returns the first cudaError_t: an oversized grid is refused,
// never run.
template <bool BM>
static cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                          const void* hs0, const void* hs1,
                          const void* cs0, const void* cs1,
                          const void* dhs0, const void* dhs1,
                          void* dz0, void* dz1, void* barrier,
                          int T, int B, int H, int d0, int ndirs, int rev_mask,
                          int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1) || H > MAX_H || barrier == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slices = (H + JS - 1) / JS;
  const size_t smem = bilstm_tm_bwd_smem_bytes(B, H);
  const void* kernel = reinterpret_cast<const void*>(lstm_bwd_kernel<BM>);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm(kernel, device, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (ndirs * slices > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;

  typedef __nv_bfloat16 bf;
  const size_t H4 = 4 * (size_t)H;
  const int ld = BM ? T : B;
  for (int b0 = 0; b0 < B; b0 += MAX_B) {
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
    unsigned int* a_bar = static_cast<unsigned int*>(barrier) + (b0 / MAX_B) * 2 * BAR_STRIDE;
    int a_T = T, a_B = B - b0 < MAX_B ? B - b0 : MAX_B, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask;
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1,
                    &a_dhs0, &a_dhs1, &a_dz0, &a_dz1, &a_bar,
                    &a_T, &a_B, &a_ld, &a_H, &a_slices, &a_d0, &a_rev};
    err = cudaLaunchCooperativeKernel(kernel, dim3(ndirs * slices), dim3(THREADS), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); streams (T, B, H);
// dz0, dz1 (T, B, 4H); barrier: bilstm_tm_bwd_barrier_words(B) zeroed
// int32 words.
extern "C" int bilstm_tm_bwd(const void* xp0, const void* xp1, const void* U,
                             const void* hs0, const void* hs1,
                             const void* cs0, const void* cs1,
                             const void* dhs0, const void* dhs1,
                             void* dz0, void* dz1, void* barrier,
                             int T, int B, int H, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, dhs0, dhs1, dz0, dz1, barrier,
                       T, B, H, 0, 2, 2, device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs, dhs (T, B, H) as the
// forward of the same `reverse` stored them; dz (T, B, 4H).
extern "C" int lstm_tm_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                           const void* dhs, void* dz, void* barrier,
                           int T, int B, int H, int reverse, int device, void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, dhs, dhs, dz, dz, barrier,
                       T, B, H, reverse, 1, 2, device, stream);
}

// D in {1, 2} batch-major directions whose forward scans ran t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs, dhs (D, B, T, H) as lstm_scan_fwd
// stored them (and the h stream's cotangent); dz (D, B, T, 4H).
extern "C" int lstm_scan_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                             const void* dhs, void* dz, void* barrier,
                             int D, int T, int B, int H, int device, void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's streams
  return launch<true>(xp, static_cast<const bf*>(xp) + 4 * n,
                      U, static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H,
                      hs, static_cast<const bf*>(hs) + n, cs, static_cast<const bf*>(cs) + n,
                      dhs, static_cast<const bf*>(dhs) + n,
                      dz, static_cast<bf*>(dz) + 4 * n, barrier,
                      T, B, H, 0, D, 0, device, stream);
}
