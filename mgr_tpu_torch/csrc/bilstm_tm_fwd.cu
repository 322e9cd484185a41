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
// What bounds it on this card: the recurrence is serial in t, and every
// unit of step t needs all of h_{t-1}. A step is a (B,H)x(H,4H) product
// per direction (256 MFLOP at B=128, H=500), too small to fill the card
// on its own, followed by a device-wide dependency. A launch per step
// would pay ~1900 launches per layer; the TPU kernel instead kept U and
// the carries in VMEM across a sequential grid.
//
// Design: ONE cooperative launch runs all T steps. Each block owns a
// slice of JS = 8 hidden units of one direction, so the four gates of
// its units are local and the gate math needs no exchange. The block
// keeps U_d[:, :, slice] resident in shared memory as f32 (H*8*4 floats =
// 64 KB at H=500). Each (batch row, unit) belongs to one thread, which
// keeps that c carry in registers for the whole sequence. h_{t-1} is
// exchanged through the bf16 h stream itself, the kernel's output: step
// t reads row t-1 (or t+1 in a reverse scan), written by every block before
// the grid barrier that ended the previous step. Each step a block
// stages h_{t-1} into shared memory in tiles of 128 batch rows; each
// thread then computes the four gates of one unit for RPT = 4 batch rows
// with plain FP32 FMAs on the bf16 values (exact products, f32 sums). A
// launch covers at most MAX_TILES tiles (256 rows), so neither registers
// nor shared memory grow with B; the host entry runs a larger batch as
// consecutive launches over slices of rows. At H=500 the grid is
// 2 x 63 = 126 blocks, one per SM; a single-direction launch is the 63
// blocks of its direction, whose per-unit arithmetic is the two-direction
// launch's, so its h and c are bit-equal to that direction of
// bilstm_tm_fwd, and so are the batch-major scan's on the same (flipped)
// projections: only the addresses differ. What limits this first version: the
// grid barrier each step, every block re-reading all of h_{t-1} from L2,
// and FP32 FMAs where tensor cores could run the product. mma/wgmma and
// a cluster exchange of h through distributed shared memory are later
// work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int JS = 8;                    // hidden units per block
constexpr int THREADS = 256;
constexpr int RPT = 4;                   // batch rows per thread
constexpr int ROW_GROUPS = THREADS / JS; // 32
constexpr int BT = ROW_GROUPS * RPT;     // batch rows per staged tile
constexpr int MAX_TILES = 2;             // tiles per launch (c carry in registers)
constexpr int MAX_B = MAX_TILES * BT;    // batch rows per launch

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

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

template <bool BM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const __nv_bfloat16* __restrict__ xp0,
                const __nv_bfloat16* __restrict__ xp1,
                const __nv_bfloat16* __restrict__ U0,
                const __nv_bfloat16* __restrict__ U1,
                __nv_bfloat16* hs0, __nv_bfloat16* hs1,
                __nv_bfloat16* cs0, __nv_bfloat16* cs1,
                int T, int B, int ld, int H, int slices, int d0, int rev_mask) {
  // B <= MAX_B rows of a batch laid out as row_at<BM>. The grid covers
  // directions d0 .. d0 + gridDim.x / slices - 1; direction d scans in
  // reverse where bit d of rev_mask is set.
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = d0 + blockIdx.x / slices;
  const bool rev = (rev_mask >> d) & 1;
  const int j0 = (blockIdx.x % slices) * JS;
  const int tid = threadIdx.x;
  const int j = tid % JS;
  const int rg = tid / JS;
  const int unit = j0 + j;
  const bool unit_ok = unit < H;
  const size_t H4 = 4 * (size_t)H;
  const int HW = H / 2;  // bf16 pairs per h row (H is even)
  // Row and pair of this thread's first staged word, and THREADS words as
  // rows and pairs (the batch-major staging's strides).
  const int r0 = tid / HW, kk0 = tid % HW, dr = THREADS / HW, dk = THREADS % HW;

  // Shared memory: u_s [H][JS][4] f32 | h_s [min(B, BT) rounded up to RPT][H] bf16.
  float* u_s = reinterpret_cast<float*>(smem);
  uint32_t* h_s = reinterpret_cast<uint32_t*>(smem + round16((size_t)H * JS * 4 * 4));

  const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
  for (int idx = tid; idx < H * JS * 4; idx += THREADS) {
    const int k = idx / (JS * 4);
    const int jj = (idx / 4) % JS;
    const int g = idx % 4;
    const int u = j0 + jj;
    u_s[idx] = u < H ? __bfloat162float(Ud[(size_t)k * H4 + (size_t)g * H + u]) : 0.0f;
  }
  __syncthreads();
  float c_reg[MAX_TILES][RPT];  // c of rows tile * BT + rg * RPT + i, unit j
#pragma unroll
  for (int tile = 0; tile < MAX_TILES; ++tile)
#pragma unroll
    for (int i = 0; i < RPT; ++i) c_reg[tile][i] = 0.0f;

  const __nv_bfloat16* xp = d == 0 ? xp0 : xp1;
  __nv_bfloat16* hs = d == 0 ? hs0 : hs1;
  __nv_bfloat16* cs = d == 0 ? cs0 : cs1;
  const float4* u4 = reinterpret_cast<const float4*>(u_s);  // [H][JS] gate quads
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const int t_prev = rev ? t + 1 : t - 1;
#pragma unroll
    for (int tile = 0; tile < MAX_TILES; ++tile) {
      const int b0 = tile * BT;
      if (b0 >= B) break;  // uniform over the block
      const int rows = min(BT, B - b0);
      float acc[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;

      if (s > 0) {  // h_{-1} = 0: step 0 is z = xp alone
        __syncthreads();  // the previous tile's readers are done with h_s
        if constexpr (BM) {  // one row of H per batch row, T * H apart
          // Word w = r * HW + kk, advanced by THREADS without a division.
          const uint32_t* h32 = reinterpret_cast<const uint32_t*>(hs);
          int r = r0, kk = kk0;
          for (int w = tid; w < rows * HW; w += THREADS) {
            h_s[w] = __ldcg(h32 + row_at<BM>(t_prev, b0 + r, ld) * HW + kk);
            r += dr;
            kk += dk;
            if (kk >= HW) kk -= HW, ++r;
          }
        } else {  // the tile's rows are contiguous
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
              hs + row_at<BM>(t_prev, b0, ld) * H);
          for (int w = tid; w < rows * HW; w += THREADS) h_s[w] = __ldcg(src + w);
        }
        __syncthreads();
        // h_s holds the tile's rows rounded up to RPT: a thread whose first
        // row is past the tile has no row to compute.
        if (rg * RPT < rows) {
          const uint32_t* h_row = h_s + (size_t)rg * RPT * HW;
          for (int kk = 0; kk < HW; ++kk) {
            const float4 ua = u4[(2 * kk) * JS + j];
            const float4 ub = u4[(2 * kk + 1) * JS + j];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const uint32_t hv = h_row[i * HW + kk];
              const float h0 = bf16_lo(hv), h1 = bf16_hi(hv);
              acc[i][0] = fmaf(h0, ua.x, acc[i][0]);
              acc[i][1] = fmaf(h0, ua.y, acc[i][1]);
              acc[i][2] = fmaf(h0, ua.z, acc[i][2]);
              acc[i][3] = fmaf(h0, ua.w, acc[i][3]);
              acc[i][0] = fmaf(h1, ub.x, acc[i][0]);
              acc[i][1] = fmaf(h1, ub.y, acc[i][1]);
              acc[i][2] = fmaf(h1, ub.z, acc[i][2]);
              acc[i][3] = fmaf(h1, ub.w, acc[i][3]);
            }
          }
        }
      }

      if (unit_ok) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg * RPT + i;
          if (r >= rows) break;
          const int b = b0 + r;
          const size_t row = row_at<BM>(t, b, ld);
          const __nv_bfloat16* xr = xp + row * H4 + unit;
          const float zi = __bfloat162float(xr[0]) + acc[i][0];
          const float zf = __bfloat162float(xr[(size_t)H]) + acc[i][1];
          const float zg = __bfloat162float(xr[2 * (size_t)H]) + acc[i][2];
          const float zo = __bfloat162float(xr[3 * (size_t)H]) + acc[i][3];
          const float ig = hard_sigmoid(zi);
          const float fg = hard_sigmoid(zf);
          const float gg = tanhf(zg);
          const float og = hard_sigmoid(zo);
          const float c = __fadd_rn(__fmul_rn(fg, c_reg[tile][i]), __fmul_rn(ig, gg));
          c_reg[tile][i] = c;
          const size_t out = row * H + unit;
          hs[out] = __float2bfloat16_rn(__fmul_rn(og, tanhf(c)));
          if (cs != nullptr) cs[out] = __float2bfloat16_rn(c);
        }
      }
    }
    if (s + 1 < T) {
      __threadfence();
      grid.sync();
    }
  }
}

}  // namespace

extern "C" const char* bilstm_tm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory the kernel needs at this (B, H).
extern "C" size_t bilstm_tm_fwd_smem_bytes(int B, int H) {
  const size_t tile_rows = ((size_t)(B < BT ? B : BT) + RPT - 1) / RPT * RPT;
  return round16((size_t)H * JS * 4 * 4) + round16(tile_rows * H * 2);
}

// Blocks per SM at this shared memory size. The kernel's shared memory
// limit is raised once per device to the most a block may opt in to (the
// limit is state of the function, so it is never lowered again for a
// smaller launch); the occupancy is found once per (device, size). One
// set of maps per layout: each is its own function.
template <bool BM>
static cudaError_t blocks_per_sm(int device, size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::map<int, int> optin;  // device -> raised limit in bytes
  static std::map<std::pair<int, size_t>, int> known;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err;
  if (optin.find(device) == optin.end()) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lstm_fwd_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    optin[device] = limit;
  }
  if (smem > (size_t)optin[device]) return cudaErrorInvalidValue;  // H too wide
  const auto key = std::make_pair(device, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, lstm_fwd_kernel<BM>,
                                                      THREADS, smem);
  if (err == cudaSuccess) known[key] = *per_sm;
  return err;
}

// Runs directions d0 .. d0 + ndirs - 1 of the recurrence on `stream`, as
// one cooperative launch per MAX_B batch rows. cs0/cs1 may be null (the c
// stream is only needed by the backward kernel). Returns the first
// cudaError_t: an oversized grid is refused, never run.
template <bool BM>
static cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                          void* hs0, void* hs1, void* cs0, void* cs1,
                          int T, int B, int H, int d0, int ndirs, int rev_mask,
                          int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slices = (H + JS - 1) / JS;
  const size_t smem = bilstm_tm_fwd_smem_bytes(B, H);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm<BM>(device, smem, &per_sm);
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
    int a_T = T, a_B = B - b0 < MAX_B ? B - b0 : MAX_B, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask;
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1,
                    &a_T, &a_B, &a_ld, &a_H, &a_slices, &a_d0, &a_rev};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_fwd_kernel<BM>),
                                      dim3(ndirs * slices), dim3(THREADS), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); direction 1 scans
// T-1 -> 0.
extern "C" int bilstm_tm_fwd(const void* xp0, const void* xp1, const void* U,
                             void* hs0, void* hs1, void* cs0, void* cs1,
                             int T, int B, int H, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, T, B, H, 0, 2, 2, device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs (T, B, H), cs may be
// null; reverse = 1 scans T-1 -> 0. Outputs at original time positions.
extern "C" int lstm_tm_fwd(const void* xp, const void* U, void* hs, void* cs,
                           int T, int B, int H, int reverse, int device, void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, T, B, H, reverse, 1, 2, device, stream);
}

// D in {1, 2} batch-major directions, each scanning t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs (D, B, T, H), cs may be null.
extern "C" int lstm_scan_fwd(const void* xp, const void* U, void* hs, void* cs,
                             int D, int T, int B, int H, int device, void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's h stream
  const bf* xp1 = static_cast<const bf*>(xp) + 4 * n;
  const bf* U1 = static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H;
  bf* hs1 = static_cast<bf*>(hs) + n;
  bf* cs1 = cs ? static_cast<bf*>(cs) + n : nullptr;
  return launch<true>(xp, xp1, U, U1, hs, hs1, cs, cs1, T, B, H, 0, D, 0, device, stream);
}
