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
// What bounds it on this card: as in the forward, the walk is serial in t
// and every unit of a step needs the dz of all units of the step before
// (dh_carry sums over all 4H columns). Per step and direction it is two
// (B,H)x(H,4H)-sized products, the z recompute and the dh_carry product,
// then a device-wide dependency.
//
// Design: ONE cooperative launch runs all T steps, with one grid barrier
// per step. Each block owns JS = 8 hidden units of one direction and keeps
// two f32 slices of U_d in shared memory: the COLUMNS U_d[:, :, slice] for
// the z recompute (as K1) and the ROWS U_d[slice, :, :] for dh_carry (64 KB
// each at H=500). Each (batch row, unit) belongs to one thread, which keeps
// that dc carry in registers for the whole walk; the dh carry of a step is
// made and used by the same thread within the next step. The only exchange
// is dz: every block writes its units' columns of dz_t into the kernel's own
// bf16 dz output, then the grid barrier, then each block reads the full dz_t
// rows back (one gate, H columns, at a time, staged through shared memory)
// to form dh_carry for its units. A step stages h_{t-1} the same way for the
// z recompute. Rows are processed in tiles of BT = 64 (RPT = 2 rows per
// thread) and a launch covers at most MAX_TILES tiles (256 rows); the host
// entry runs a larger batch as consecutive launches over slices of rows.
// At H=500 the grid is 2 x 63 = 126 blocks, one per SM, and shared memory
// 192 KB; a single-direction launch is the 63 blocks of its direction, with
// the per-unit arithmetic of the two-direction launch, so its dz is
// bit-equal to that direction of bilstm_tm_bwd, and so is the batch-major
// walk's on the same (flipped) operands. What limits this first version: the grid barrier each step,
// every block re-reading all of dz_t and h_{t-1} from L2, and FP32 FMAs
// where tensor cores could run both products.

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
constexpr int RPT = 2;                   // batch rows per thread
constexpr int ROW_GROUPS = THREADS / JS; // 32
constexpr int BT = ROW_GROUPS * RPT;     // batch rows per staged tile
constexpr int MAX_TILES = 4;             // tiles per launch (dc carry in registers)
constexpr int MAX_B = MAX_TILES * BT;    // batch rows per launch

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Row (t, b) of a stream: t * ld + b time-major, b * ld + t batch-major.
template <bool BM>
__device__ __forceinline__ size_t row_at(int t, int b, int ld) {
  return BM ? (size_t)b * ld + t : (size_t)t * ld + b;
}

// Keras hard_sigmoid, rounded as in bilstm_tm_fwd.cu.
__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);
}

// Its derivative as the TPU kernel takes it: 0.2 on the open interval.
__device__ __forceinline__ float hard_sigmoid_grad(float x) {
  return (x > -2.5f && x < 2.5f) ? 0.2f : 0.0f;
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
                __nv_bfloat16* dz0, __nv_bfloat16* dz1,
                int T, int B, int ld, int H, int slices, int d0, int rev_mask) {
  // B <= MAX_B rows of a batch laid out as row_at<BM>. The grid covers
  // directions d0 .. d0 + gridDim.x / slices - 1; direction d's forward
  // scan ran in reverse where bit d of rev_mask is set.
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
  const int HW = H / 2;  // bf16 pairs per H-long row segment (H is even)
  // Row and pair of this thread's first staged word, and THREADS words as
  // rows and pairs (the batch-major staging's strides).
  const int r0 = tid / HW, kk0 = tid % HW, dr = THREADS / HW, dk = THREADS % HW;

  // Shared memory: uc_s [H][JS] gate quads f32 | ur_s [4][HW][JS] float2 |
  // stage_s [min(B, BT) rounded up to RPT][HW] bf16 pairs.
  float* uc_s = reinterpret_cast<float*>(smem);
  float2* ur_s = reinterpret_cast<float2*>(smem + round16((size_t)H * JS * 4 * 4));
  uint32_t* stage_s = reinterpret_cast<uint32_t*>(
      smem + round16((size_t)H * JS * 4 * 4) + round16((size_t)4 * H * JS * 4));

  const __nv_bfloat16* Ud = d == 0 ? U0 : U1;
  for (int idx = tid; idx < H * JS * 4; idx += THREADS) {
    const int k = idx / (JS * 4);
    const int jj = (idx / 4) % JS;
    const int g = idx % 4;
    const int u = j0 + jj;
    uc_s[idx] = u < H ? __bfloat162float(Ud[(size_t)k * H4 + (size_t)g * H + u]) : 0.0f;
  }
  for (int idx = tid; idx < 4 * HW * JS; idx += THREADS) {
    const int jj = idx % JS;
    const int col = 2 * (idx / JS);  // g * H + 2 kk
    const int u = j0 + jj;
    float2 v = make_float2(0.0f, 0.0f);
    if (u < H) {
      v.x = __bfloat162float(Ud[(size_t)u * H4 + col]);
      v.y = __bfloat162float(Ud[(size_t)u * H4 + col + 1]);
    }
    ur_s[idx] = v;
  }
  __syncthreads();

  float dc_reg[MAX_TILES][RPT];  // dc carry of rows tile * BT + rg * RPT + i, unit j
#pragma unroll
  for (int tile = 0; tile < MAX_TILES; ++tile)
#pragma unroll
    for (int i = 0; i < RPT; ++i) dc_reg[tile][i] = 0.0f;

  const __nv_bfloat16* xp = d == 0 ? xp0 : xp1;
  const __nv_bfloat16* hs = d == 0 ? hs0 : hs1;
  const __nv_bfloat16* cs = d == 0 ? cs0 : cs1;
  const __nv_bfloat16* dhs = d == 0 ? dhs0 : dhs1;
  __nv_bfloat16* dz = d == 0 ? dz0 : dz1;
  const float4* u4 = reinterpret_cast<const float4*>(uc_s);  // [H][JS] gate quads
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int t_pre = rev ? t + 1 : t - 1;   // where this step's pre-state lives
    const int t_last = rev ? t - 1 : t + 1;  // the step walked before this one
    const bool has_pre = t_pre >= 0 && t_pre < T;
#pragma unroll
    for (int tile = 0; tile < MAX_TILES; ++tile) {
      const int b0 = tile * BT;
      if (b0 >= B) break;  // uniform over the block
      const int rows = min(BT, B - b0);
      const bool rows_ok = rg * RPT < rows;  // the staged tile is rounded up to RPT

      // dh carry: dz_{t_last} . U_d^T for this block's units, one gate at a time.
      float dh_acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dh_acc[i] = 0.0f;
      if (s > 0) {
        const uint32_t* dz32 = reinterpret_cast<const uint32_t*>(dz);
        for (int g = 0; g < 4; ++g) {
          __syncthreads();  // the previous readers are done with stage_s
          if constexpr (BM) {  // word w = r * HW + kk, advanced without a division
            int r = r0, kk = kk0;
            for (int w = tid; w < rows * HW; w += THREADS) {
              stage_s[w] = __ldcg(dz32 + (row_at<BM>(t_last, b0 + r, ld) * H4 + (size_t)g * H) / 2 + kk);
              r += dr;
              kk += dk;
              if (kk >= HW) kk -= HW, ++r;
            }
          } else {
            for (int w = tid; w < rows * HW; w += THREADS) {
              const int r = w / HW, kk = w % HW;
              stage_s[w] = __ldcg(dz32 + (row_at<BM>(t_last, b0 + r, ld) * H4 + (size_t)g * H) / 2 + kk);
            }
          }
          __syncthreads();
          if (rows_ok) {
            const uint32_t* dz_row = stage_s + (size_t)rg * RPT * HW;
            const float2* urg = ur_s + (size_t)g * HW * JS;
            for (int kk = 0; kk < HW; ++kk) {
              const float2 u = urg[kk * JS + j];
#pragma unroll
              for (int i = 0; i < RPT; ++i) {
                const uint32_t v = dz_row[i * HW + kk];
                dh_acc[i] = fmaf(bf16_lo(v), u.x, dh_acc[i]);
                dh_acc[i] = fmaf(bf16_hi(v), u.y, dh_acc[i]);
              }
            }
          }
        }
      }

      // z recompute: xp_d[t] + bf16(h_pre) . U_d[:, :, unit], as K1 does.
      float acc[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
      if (has_pre) {
        __syncthreads();
        if constexpr (BM) {  // one row of H per batch row, T * H apart
          const uint32_t* h32 = reinterpret_cast<const uint32_t*>(hs);
          int r = r0, kk = kk0;
          for (int w = tid; w < rows * HW; w += THREADS) {
            stage_s[w] = h32[row_at<BM>(t_pre, b0 + r, ld) * HW + kk];
            r += dr;
            kk += dk;
            if (kk >= HW) kk -= HW, ++r;
          }
        } else {  // the tile's rows are contiguous
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
              hs + row_at<BM>(t_pre, b0, ld) * H);
          for (int w = tid; w < rows * HW; w += THREADS) stage_s[w] = src[w];
        }
        __syncthreads();
        if (rows_ok) {
          const uint32_t* h_row = stage_s + (size_t)rg * RPT * HW;
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
          const size_t row4 = row * H4 + unit;
          const float zi = __bfloat162float(xp[row4]) + acc[i][0];
          const float zf = __bfloat162float(xp[row4 + (size_t)H]) + acc[i][1];
          const float zg = __bfloat162float(xp[row4 + 2 * (size_t)H]) + acc[i][2];
          const float zo = __bfloat162float(xp[row4 + 3 * (size_t)H]) + acc[i][3];
          const float ig = hard_sigmoid(zi);
          const float fg = hard_sigmoid(zf);
          const float gg = tanhf(zg);
          const float og = hard_sigmoid(zo);
          const size_t at = row * H + unit;
          const float tc = tanhf(__bfloat162float(cs[at]));
          const float c_pre =
              has_pre ? __bfloat162float(cs[row_at<BM>(t_pre, b, ld) * H + unit]) : 0.0f;
          const float dh = __bfloat162float(dhs[at]) + dh_acc[i];
          const float d_o = dh * tc;
          const float dc = dc_reg[tile][i] + dh * og * (1.0f - tc * tc);
          dz[row4] = __float2bfloat16_rn((dc * gg) * hard_sigmoid_grad(zi));
          dz[row4 + (size_t)H] = __float2bfloat16_rn((dc * c_pre) * hard_sigmoid_grad(zf));
          dz[row4 + 2 * (size_t)H] = __float2bfloat16_rn((dc * ig) * (1.0f - gg * gg));
          dz[row4 + 3 * (size_t)H] = __float2bfloat16_rn(d_o * hard_sigmoid_grad(zo));
          dc_reg[tile][i] = dc * fg;
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

extern "C" const char* bilstm_tm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory the kernel needs at this (B, H).
extern "C" size_t bilstm_tm_bwd_smem_bytes(int B, int H) {
  const size_t tile_rows = ((size_t)(B < BT ? B : BT) + RPT - 1) / RPT * RPT;
  return round16((size_t)H * JS * 4 * 4) + round16((size_t)4 * H * JS * 4) +
         round16(tile_rows * H * 2);
}

// Blocks per SM at this shared memory size; the kernel's shared memory
// limit is raised once per device to the opt-in maximum and never lowered
// (the same rule as bilstm_tm_fwd.cu, where lowering it broke a later,
// wider launch with error 720). One set of maps per layout.
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
    err = cudaFuncSetAttribute(lstm_bwd_kernel<BM>,
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, lstm_bwd_kernel<BM>,
                                                      THREADS, smem);
  if (err == cudaSuccess) known[key] = *per_sm;
  return err;
}

// Runs the backward walk of directions d0 .. d0 + ndirs - 1 on `stream`, as
// one cooperative launch per MAX_B batch rows. Returns the first
// cudaError_t: an oversized grid is refused, never run.
template <bool BM>
static cudaError_t launch(const void* xp0, const void* xp1, const void* U0, const void* U1,
                          const void* hs0, const void* hs1,
                          const void* cs0, const void* cs1,
                          const void* dhs0, const void* dhs1,
                          void* dz0, void* dz1,
                          int T, int B, int H, int d0, int ndirs, int rev_mask,
                          int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (H & 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slices = (H + JS - 1) / JS;
  const size_t smem = bilstm_tm_bwd_smem_bytes(B, H);
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
    const bf* a_hs0 = static_cast<const bf*>(hs0) + r0 * H;
    const bf* a_hs1 = static_cast<const bf*>(hs1) + r0 * H;
    const bf* a_cs0 = static_cast<const bf*>(cs0) + r0 * H;
    const bf* a_cs1 = static_cast<const bf*>(cs1) + r0 * H;
    const bf* a_dhs0 = static_cast<const bf*>(dhs0) + r0 * H;
    const bf* a_dhs1 = static_cast<const bf*>(dhs1) + r0 * H;
    bf* a_dz0 = static_cast<bf*>(dz0) + r0 * H4;
    bf* a_dz1 = static_cast<bf*>(dz1) + r0 * H4;
    int a_T = T, a_B = B - b0 < MAX_B ? B - b0 : MAX_B, a_ld = ld, a_H = H;
    int a_slices = slices, a_d0 = d0, a_rev = rev_mask;
    void* args[] = {&a_xp0, &a_xp1, &a_U0, &a_U1, &a_hs0, &a_hs1, &a_cs0, &a_cs1,
                    &a_dhs0, &a_dhs1, &a_dz0, &a_dz1,
                    &a_T, &a_B, &a_ld, &a_H, &a_slices, &a_d0, &a_rev};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_bwd_kernel<BM>),
                                      dim3(ndirs * slices), dim3(THREADS), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Both directions: xp0, xp1 (T, B, 4H); U (2, H, 4H); streams (T, B, H);
// dz0, dz1 (T, B, 4H).
extern "C" int bilstm_tm_bwd(const void* xp0, const void* xp1, const void* U,
                             const void* hs0, const void* hs1,
                             const void* cs0, const void* cs1,
                             const void* dhs0, const void* dhs1,
                             void* dz0, void* dz1,
                             int T, int B, int H, int device, void* stream) {
  const void* U1 = static_cast<const __nv_bfloat16*>(U) + (size_t)H * 4 * H;
  return launch<false>(xp0, xp1, U, U1, hs0, hs1, cs0, cs1, dhs0, dhs1, dz0, dz1,
                       T, B, H, 0, 2, 2, device, stream);
}

// One direction: xp (T, B, 4H); U (H, 4H); hs, cs, dhs (T, B, H) as the
// forward of the same `reverse` stored them; dz (T, B, 4H).
extern "C" int lstm_tm_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                           const void* dhs, void* dz,
                           int T, int B, int H, int reverse, int device, void* stream) {
  if (reverse != 0 && reverse != 1) return cudaErrorInvalidValue;
  return launch<false>(xp, xp, U, U, hs, hs, cs, cs, dhs, dhs, dz, dz,
                       T, B, H, reverse, 1, 2, device, stream);
}

// D in {1, 2} batch-major directions whose forward scans ran t = 0 -> T-1:
// xp (D, B, T, 4H); U (D, H, 4H); hs, cs, dhs (D, B, T, H) as lstm_scan_fwd
// stored them (and the h stream's cotangent); dz (D, B, T, 4H).
extern "C" int lstm_scan_bwd(const void* xp, const void* U, const void* hs, const void* cs,
                             const void* dhs, void* dz,
                             int D, int T, int B, int H, int device, void* stream) {
  if (D != 1 && D != 2) return cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  const size_t n = (size_t)(D - 1) * B * T * H;  // offset of direction 1's streams
  return launch<true>(xp, static_cast<const bf*>(xp) + 4 * n,
                      U, static_cast<const bf*>(U) + (size_t)(D - 1) * H * 4 * H,
                      hs, static_cast<const bf*>(hs) + n, cs, static_cast<const bf*>(cs) + n,
                      dhs, static_cast<const bf*>(dhs) + n,
                      dz, static_cast<bf*>(dz) + 4 * n,
                      T, B, H, 0, D, 0, device, stream);
}
