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
// every other block of the direction. A step costs the latency of one L2
// round trip for h_{t-1}, a short chain of tensor-core products, a
// reduction through shared memory, the gate math and the barrier.
//
// Design: ONE cooperative launch runs all T steps. Each block owns a
// slice of JS = 8 hidden units of one direction (32 columns: 4 gates x 8
// units), so the gate math needs no exchange, and keeps its c carry in
// registers, one thread per (batch row, unit) of a 32-row tile. h_{t-1} is
// exchanged through the bf16 h stream itself, the kernel's output.
//   - The step product runs on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 sums; lstm_common.cuh): z[rows, 32] = h_{t-1} . U_d[:, slice].
//     The K axis (H, padded to k16 steps with zeros in both operands) is
//     split over the 8 warps, 4 k16 steps each (H <= 512), so every warp
//     works at every B; the partial sums meet in shared memory and are
//     added in warp order. The partition depends only on H, so the two-
//     direction launch, one direction (lstm_tm_fwd) and the batch-major
//     scan give bit-equal h and c, and two launches give identical bits.
//   - U_d's slice stays in registers as bf16 B fragments for the whole
//     sequence (32 registers a thread).
//   - Each warp reads its K slice of h_{t-1} straight into A fragments
//     with 8-byte L2 loads (.cg: other blocks wrote it during the launch,
//     and L1 is not coherent). An h row is 2H bytes, 8-byte aligned only
//     (4-byte where H % 4 == 2), which is why the loads are 8 bytes wide
//     and not a 16-byte cp.async.cg or TMA copy; the loads of a tile are
//     all issued before its first product.
//   - A per-direction split barrier replaces the grid-wide one: a block
//     ARRIVES on its direction's counter after its h stores and WAITS on it
//     before reading h_{t-1}; the two directions never wait on each other.
//     Between arrive and wait it prefetches the next step's xp columns of
//     its rows into shared memory with cp.async, so no load but h_{t-1}'s
//     is left on the serial path. The counters live in a scratch tensor
//     the wrapper zeroes for each call (bilstm_tm_fwd_barrier_words).
// A launch covers at most MAX_B = 256 rows (8 tiles of 32, carried in
// registers); the host entry runs a larger batch as consecutive launches
// over slices of rows. At H=500 the grid is 2 x 63 = 126 blocks, one per
// SM; the cooperative launch refuses a grid that cannot be resident, which
// the spin barrier needs. Shared memory: 40 KB of partial sums + 64 B of
// xp per row (57 KB at 256 rows).
// What it leaves: wgmma (the step is latency-bound: M is the batch, 32
// rows at the train batch, below wgmma's 64, and a step issues ~32 mma per
// warp); exchanging h through distributed shared memory in a cluster in
// place of L2 (a direction's 63 blocks exceed a cluster); overlapping one
// tile's loads with the previous tile's gate math at B > 32; K6's layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

template <bool BM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const __nv_bfloat16* __restrict__ xp0,
                const __nv_bfloat16* __restrict__ xp1,
                const __nv_bfloat16* __restrict__ U0,
                const __nv_bfloat16* __restrict__ U1,
                __nv_bfloat16* hs0, __nv_bfloat16* hs1,
                __nv_bfloat16* cs0, __nv_bfloat16* cs1, unsigned int* barrier,
                int T, int B, int ld, int H, int slices, int d0, int rev_mask) {
  // B <= MAX_B rows of a batch laid out as row_at<BM>. The grid covers
  // directions d0 .. d0 + gridDim.x / slices - 1; direction d scans in
  // reverse where bit d of rev_mask is set.
  extern __shared__ __align__(16) unsigned char smem[];
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
}

}  // namespace

extern "C" const char* bilstm_tm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory the kernel needs at this (B, H).
extern "C" size_t bilstm_tm_fwd_smem_bytes(int B, int H) {
  (void)H;
  const size_t rows = (size_t)(B < MAX_B ? B : MAX_B);
  return sizeof(float) * RED_Z_FLOATS + round16(rows * 4 * JS * 2);
}

// Words of the zeroed int32 scratch a call at batch B takes as `barrier`.
extern "C" int bilstm_tm_fwd_barrier_words(int B) { return barrier_words(B); }

// Runs directions d0 .. d0 + ndirs - 1 of the recurrence on `stream`, as
// one cooperative launch per MAX_B batch rows, each on its own counters in
// `barrier`. cs0/cs1 may be null (the c stream is only needed by the
// backward kernel). Returns the first cudaError_t: an oversized grid is
// refused, never run.
template <bool BM>
static cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                          void* hs0, void* hs1, void* cs0, void* cs1, void* barrier,
                          int T, int B, int H, int d0, int ndirs, int rev_mask,
                          int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1) || H > MAX_H || barrier == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slices = (H + JS - 1) / JS;
  const size_t smem = bilstm_tm_fwd_smem_bytes(B, H);
  const void* kernel = reinterpret_cast<const void*>(lstm_fwd_kernel<BM>);
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
    bf* a_hs0 = static_cast<bf*>(hs0) + r0 * H;
    bf* a_hs1 = static_cast<bf*>(hs1) + r0 * H;
    bf* a_cs0 = cs0 ? static_cast<bf*>(cs0) + r0 * H : nullptr;
    bf* a_cs1 = cs1 ? static_cast<bf*>(cs1) + r0 * H : nullptr;
    unsigned int* a_bar = static_cast<unsigned int*>(barrier) + (b0 / MAX_B) * 2 * BAR_STRIDE;
    int a_T = T, a_B = B - b0 < MAX_B ? B - b0 : MAX_B, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask;
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1, &a_bar,
                    &a_T, &a_B, &a_ld, &a_H, &a_slices, &a_d0, &a_rev};
    err = cudaLaunchCooperativeKernel(kernel, dim3(ndirs * slices), dim3(THREADS), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); direction 1 scans
// T-1 -> 0; barrier: bilstm_tm_fwd_barrier_words(B) zeroed int32 words.
extern "C" int bilstm_tm_fwd(const void* xp0, const void* xp1, const void* U,
                             void* hs0, void* hs1, void* cs0, void* cs1, void* barrier,
                             int T, int B, int H, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, barrier, T, B, H, 0, 2, 2,
                       device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs (T, B, H), cs may be
// null; reverse = 1 scans T-1 -> 0. Outputs at original time positions.
extern "C" int lstm_tm_fwd(const void* xp, const void* U, void* hs, void* cs, void* barrier,
                           int T, int B, int H, int reverse, int device, void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, barrier, T, B, H, reverse, 1, 2, device,
                       stream);
}

// D in {1, 2} batch-major directions, each scanning t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs (D, B, T, H), cs may be null.
extern "C" int lstm_scan_fwd(const void* xp, const void* U, void* hs, void* cs, void* barrier,
                             int D, int T, int B, int H, int device, void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's h stream
  const bf* xp1 = static_cast<const bf*>(xp) + 4 * n;
  const bf* U1 = static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H;
  bf* hs1 = static_cast<bf*>(hs) + n;
  bf* cs1 = cs ? static_cast<bf*>(cs) + n : nullptr;
  return launch<true>(xp, xp1, U, U1, hs, hs1, cs, cs1, barrier, T, B, H, 0, D, 0, device,
                      stream);
}
