// CTC backward: the exact adjoint of the alpha recursion, for Hopper (sm_90a).
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_ctc_bwd_kernel
// (launched by _ctc_pallas_bwd from the custom VJP _ctc_alpha_loss_bwd of
// pallas_ctc_loss). Same function, walking time in reverse over the
// post-step alphas that ctc_fwd.cu stored (alpha_phi (T, B, N+1), alpha_emit
// (T, B, N) f32, time-major, rows alpha_pitch(w) floats apart), on the
// state of N+1 lattice columns:
//
//   seeds:  dphi[L] = g_phi,  demit[L-1] = g_emit (L > 0)
//   for t = len-1 .. 0, with prev = the alphas of t-1 (the initial state at
//   t = 0: emit NEG, phi 0 at column 0 and NEG elsewhere) and cur = those of t:
//     shift[n] = n == 0 ? NEG : emit_prev[n-1];  sa = shift + skip
//     ye = emit_cur - lp[t, label];  yp = phi_cur - lp[t, blank]
//     d lp[t, label[n]] += demit[n];  d lp[t, blank] += sum_n dphi[n]
//     demit'[n] = demit[n] e^(emit_prev[n] - ye[n]) + dsa[n+1] + des[n+1]
//     dphi'[n]  = demit[n] e^(phi_prev[n] - ye[n]) + dphi[n] e^(phi_prev[n] - yp)
//       with dsa[n] = demit[n] e^(sa[n] - ye[n]) and des[n] = dphi[n] e^(shift[n] - yp)
//   frames t >= input_length get exactly 0 (the carries pass through them).
//
// Output: d log_probs (T, B, K) f32, written straight from the kernel. The
// TPU kernel emits d lp on its packed (B, T, N+1) state and lets the VJP of
// the one-hot packing einsum scatter it back to the K classes; here the
// kernel scatters itself, which skips a (T, B, N+1) intermediate (37 MB at
// the speech shapes) and a pass over it.
//
// What bounds it on this card: the serial chain of a step, len steps long:
// the shared-memory reads of the staged frame, the products demit e^(..)
// and dphi e^(..), the exchange of dsa / des through shared memory and one
// block barrier. Its five exponentials read only the stored alphas and
// log-probs, not the adjoints, so they are off the chain. The bytes (about
// 2 x 37 MB of alphas and 11 MB of log-probs read, 11 MB of d lp written at
// B=32, T'=1898, N=150, K=44) bound it far below that.
//
// Design: one block per sequence and one thread per lattice column, rounded
// up to whole warps; nothing is shared between blocks. A column's adjoints
// stay in registers.
//   - Frames staged ahead. Walking time in reverse in chunks of C frames,
//     the block stages a chunk into one of two ring buffers in shared
//     memory while it consumes the other; it waits and syncs only at chunk
//     boundaries. A staged frame t holds the phi and emit rows of t-1 and
//     the log-prob row of t (the initial state is written in place of the
//     rows of t = -1). The alpha rows start 16-byte aligned (their pitch,
//     set by K3), so each is one bulk copy by the TMA unit, issued by a
//     lane of warp 0 and counted on the buffer's mbarrier; the log-prob
//     rows (K floats, any alignment) go by 4-byte cp.async. The alphas of
//     t are carried in registers from the step that read them as t-1's,
//     and emit_prev[n-1] is a shared read of the staged row. (Staging the
//     alpha rows by 4-byte cp.async, at any pitch, was this kernel's first
//     design: PERF.md section 6 has both times.)
//   - The scatter, without atomics and off the chain. Nothing in the
//     recursion reads d lp, so each step only parks its columns' demit and
//     its per-warp sums of dphi in chunk buffers. At the chunk's end the
//     block writes the chunk's rows of d lp, coalesced: the entry (t, k)
//     sums the columns of class k in column order, and the blank adds its
//     step's warp sums in warp order. The class -> columns lists are built
//     once per block from the labels: the columns n < L of each class k < K
//     (a label >= K scores 0 and gets no gradient; a -1 pad reads as class
//     0; a column n >= L carries an exact zero adjoint, so it is left out).
//     Every sum has a fixed order, so two launches give identical bits.
//   - The exponentials are expf, not the fast __expf: they multiply the
//     adjoints at every step, so their rounding is carried over all T'
//     steps (the tolerance against the plain version is 1e-4 absolute).
//   - Shared memory, with Wp, Np, Kp = N+1, N, K rounded up to multiples of
//     4: the ring 2 C (Wp + Np + Kp) floats, the chunk buffers C (N + 32)
//     floats, the exchange, the class lists and two mbarriers O(N + K). C
//     is the most frames that fit a 64 KiB budget, within [2, 16]:
//     C = clamp((65536 - fixed) / (4 (2 (Wp + Np + Kp) + N + 32)), 2, 16),
//     fixed = 4 (4 + 4 (N+2) + 2N + K + 1). At N = 150, K = 44 that is
//     C = 16 (60.0 KB); at N = 1023 the floor, C = 2 (66.7 KB). Dynamic
//     shared memory above 48 KB is opted in to once per device.

#include <cuda_runtime.h>

#include "ctc_common.cuh"

namespace {

using namespace ctc;

constexpr size_t SMEM_BUDGET = 64 * 1024;
constexpr int CHUNK_MIN = 2;

// Floats of one staged frame: the phi row, the emit row, the log-prob row.
int frame_floats(int N, int K) { return alpha_pitch(N + 1) + alpha_pitch(N) + alpha_pitch(K); }

size_t fixed_bytes(int N, int K) {
  return (4 + 4 * (size_t)(N + 2) + 2 * (size_t)N + K + 1) * sizeof(float);
}

size_t frame_bytes(int N, int K) {
  return (2 * (size_t)frame_floats(N, K) + N + MAX_WARPS) * sizeof(float);
}

int chunk_frames(int N, int K) {
  const size_t fixed = fixed_bytes(N, K), frame = frame_bytes(N, K);
  const size_t c = SMEM_BUDGET > fixed ? (SMEM_BUDGET - fixed) / frame : 0;
  return (int)(c < CHUNK_MIN ? CHUNK_MIN : (c > (size_t)CHUNK_MAX ? CHUNK_MAX : c));
}

size_t smem_bytes(int N, int K, int C) { return fixed_bytes(N, K) + C * frame_bytes(N, K); }

__global__ void __launch_bounds__(MAX_THREADS)
    ctc_bwd_kernel(const float* __restrict__ log_probs, const int* __restrict__ labels,
                   const int* __restrict__ input_lengths,
                   const int* __restrict__ label_lengths,
                   const float* __restrict__ alpha_phi, const float* __restrict__ alpha_emit,
                   const float* __restrict__ g_phi, const float* __restrict__ g_emit,
                   float* __restrict__ dlp, int T, int B, int K, int N, int blank, int C) {
  // Shared memory: bars [2] (16 bytes) | ring [2][C][F] (F = Wp + Np + Kp:
  // phi row of t-1 | emit row of t-1 | lp row of t) | dem_s [C][N] |
  // wsum_s [C][MAX_WARPS] | dsa_s [2][W+1] | des_s [2][W+1] | lab_s [N] |
  // cols_s [N] | start_s [K+1].
  extern __shared__ __align__(16) float smem[];
  const int W = N + 1;
  const int Wp = alpha_pitch(W), Np = alpha_pitch(N);
  const int F = Wp + Np + alpha_pitch(K);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  float* ring = smem + 4;
  float* dem_s = ring + 2 * (size_t)C * F;
  float* wsum_s = dem_s + (size_t)C * N;
  float* dsa_s = wsum_s + (size_t)C * MAX_WARPS;
  float* des_s = dsa_s + 2 * (W + 1);
  int* lab_s = reinterpret_cast<int*>(des_s + 2 * (W + 1));
  int* cols_s = lab_s + N;
  int* start_s = cols_s + N;

  const int b = blockIdx.x;
  const int n = threadIdx.x;
  const int lane = n & 31, warp = n >> 5;
  const bool column = n <= N;
  const bool emit_col = n < N;

  int label = blank;
  float skip = 0.0f;
  if (emit_col) column_label(labels + (size_t)b * N, n, &label, &skip);
  const int len = max(min(input_lengths[b], T), 0);
  const int L = min(max(label_lengths[b], 0), N);

  // Frames past the length: exactly zero.
  for (int i = n; i < (T - len) * K; i += blockDim.x) {
    const int t = len + i / K;
    dlp[((size_t)t * B + b) * K + i % K] = 0.0f;
  }
  for (int i = n; i < 2 * (W + 1); i += blockDim.x) dsa_s[i] = des_s[i] = 0.0f;
  if (emit_col) lab_s[n] = label;
  if (n == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
  }
  __syncthreads();
  // Class k's columns are cols_s[start_s[k] .. start_s[k+1]), in column
  // order: start_s[k] counts the columns n < L of a class below k.
  for (int k = n; k <= K; k += blockDim.x) {
    int below = 0;
    for (int m = 0; m < L; ++m) below += lab_s[m] < k;
    start_s[k] = below;
  }
  __syncthreads();
  if (n < L && label < K) {
    int before = 0;
    for (int m = 0; m < n; ++m) before += lab_s[m] == label;
    cols_s[start_s[label] + before] = n;
  }  // visible after the first chunk's __syncthreads

  float demit = (emit_col && L > 0 && n == L - 1) ? g_emit[b] : 0.0f;
  float dphi = (column && n == L) ? g_phi[b] : 0.0f;
  float e_cur = NEG, p_cur = NEG;
  if (len > 0) {
    if (emit_col) e_cur = alpha_emit[((size_t)(len - 1) * B + b) * Np + n];
    if (column) p_cur = alpha_phi[((size_t)(len - 1) * B + b) * Wp + n];
  }

  // Chunk j holds frames [lo, hi), hi = len - j C, lo = max(hi - C, 0),
  // staged into ring buffer j & 1: the alpha rows by bulk copies on
  // bars[j & 1], the log-prob rows in one cp.async group.
  const int chunks = (len + C - 1) / C;
  auto stage = [&](int j) {
    if (j < chunks) {
      const int hi = len - j * C, lo = max(hi - C, 0);
      const int t1 = max(lo, 1);  // frames t1 .. hi-1 copy the rows of t-1
      float* dst = ring + (size_t)(j & 1) * C * F;
      if (warp == 0) {
        if (lane == 0) mbar_arrive_expect_tx(&bars[j & 1], (uint32_t)(hi - t1) * (Wp + Np) * 4);
        __syncwarp();
        for (int t = t1 + lane; t < hi; t += 32) {
          const size_t row = (size_t)(t - 1) * B + b;
          float* f = dst + (size_t)(t - lo) * F;
          bulk_copy(f, alpha_phi + row * Wp, Wp * 4, &bars[j & 1]);
          if (Np > 0) bulk_copy(f + Wp, alpha_emit + row * Np, Np * 4, &bars[j & 1]);
        }
      }
      if (lo == 0) {  // the initial state in place of the rows of t = -1
        if (column) dst[n] = n == 0 ? 0.0f : NEG;
        if (emit_col) dst[Wp + n] = NEG;
      }
      for (int i = n; i < (hi - lo) * K; i += blockDim.x) {
        const int r = i / K, k = i - r * K;
        cp_async4(dst + (size_t)r * F + Wp + Np + k,
                  log_probs + ((size_t)(lo + r) * B + b) * K + k);
      }
    }
    cp_async_commit();
  };

  stage(0);
  int buf = 0;
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<0>();                   // this thread's log-prob copies of chunk j
    mbar_wait(&bars[j & 1], (j >> 1) & 1);  // the chunk's alpha rows
    __syncthreads();  // everyone's copies and stores; chunk j-1's buffers are read out
    stage(j + 1);
    const int hi = len - j * C, lo = max(hi - C, 0);
    const float* frames = ring + (size_t)(j & 1) * C * F;
    for (int t = hi - 1; t >= lo; --t) {
      const int r = t - lo;
      const float* f = frames + (size_t)r * F;
      const float* lp = f + Wp + Np;
      float p_prev = NEG, e_prev = NEG, shift = NEG;
      if (column) {
        p_prev = f[n];
        if (n > 0) shift = f[Wp + n - 1];
      }
      if (emit_col) e_prev = f[Wp + n];

      float w_a = 0.0f, w_p = 0.0f, dsa = 0.0f, w_pp = 0.0f, des = 0.0f;
      if (emit_col) {
        const float ye = e_cur - (label < K ? lp[label] : 0.0f);
        w_a = expf(e_prev - ye);
        w_p = expf(p_prev - ye);
        dsa = demit * expf(shift + skip - ye);
        dem_s[r * N + n] = demit;
      }
      if (column) {
        const float yp = p_cur - lp[blank];
        w_pp = expf(p_prev - yp);
        des = dphi * expf(shift - yp);
        dsa_s[buf * (W + 1) + n] = dsa;
        des_s[buf * (W + 1) + n] = des;
      }
      float sum = column ? dphi : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) wsum_s[r * MAX_WARPS + warp] = sum;
      __syncthreads();

      float demit_prev = 0.0f, dphi_prev = 0.0f;
      if (emit_col) {
        demit_prev = demit * w_a + dsa_s[buf * (W + 1) + n + 1];
        demit_prev = demit_prev + des_s[buf * (W + 1) + n + 1];
      }
      if (column) dphi_prev = demit * w_p + dphi * w_pp;
      demit = demit_prev;
      dphi = dphi_prev;
      e_cur = e_prev;
      p_cur = p_prev;
      buf ^= 1;
    }
    __syncthreads();  // the chunk's dem_s and wsum_s are complete
    const int warps = blockDim.x >> 5;
    for (int i = n; i < (hi - lo) * K; i += blockDim.x) {
      const int r = i / K, k = i - r * K;
      float v = 0.0f;
      for (int q = start_s[k]; q < start_s[k + 1]; ++q) v += dem_s[r * N + cols_s[q]];
      if (k == blank) {
        float s = 0.0f;
        for (int w = 0; w < warps; ++w) s += wsum_s[r * MAX_WARPS + w];
        v += s;
      }
      dlp[((size_t)(lo + r) * B + b) * K + k] = v;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" const char* ctc_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch K4 makes for N labels and K classes: threads per block, frames
// per staged chunk and dynamic shared memory in bytes.
extern "C" int ctc_bwd_launch_shape(int N, int K, int* threads, int* chunk, int* smem) {
  if (N < 0 || N + 1 > MAX_THREADS || K <= 0) return cudaErrorInvalidValue;
  *threads = block_threads(N);
  *chunk = chunk_frames(N, K);
  *smem = (int)smem_bytes(N, K, *chunk);
  return cudaSuccess;
}

// Launches B blocks of ceil32(N + 1) threads on `stream`; returns the
// cudaError_t of the launch. alpha_phi (T, B, alpha_pitch(N + 1)) and
// alpha_emit (T, B, alpha_pitch(N)) hold the alphas in their first N + 1 /
// N columns, 16-byte aligned (as ctc_fwd stores them); g_phi, g_emit (B,)
// f32 are the loss's seeds at phi[L] and emit[L-1]; dlp (T, B, K) f32 is
// written in full.
extern "C" int ctc_bwd(const void* log_probs, const void* labels,
                       const void* input_lengths, const void* label_lengths,
                       const void* alpha_phi, const void* alpha_emit,
                       const void* g_phi, const void* g_emit, void* dlp,
                       int T, int B, int K, int N, int blank,
                       int device, void* stream) {
  if (T < 0 || B <= 0 || K <= 0 || N < 0 || N + 1 > MAX_THREADS || blank < 0 || blank >= K ||
      (reinterpret_cast<uintptr_t>(alpha_phi) & 15) || (reinterpret_cast<uintptr_t>(alpha_emit) & 15))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int C = chunk_frames(N, K);
  const size_t smem = smem_bytes(N, K, C);
  err = allow_smem(reinterpret_cast<const void*>(ctc_bwd_kernel), device, smem);
  if (err != cudaSuccess) return err;
  ctc_bwd_kernel<<<B, block_threads(N), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int*>(labels),
      static_cast<const int*>(input_lengths), static_cast<const int*>(label_lengths),
      static_cast<const float*>(alpha_phi), static_cast<const float*>(alpha_emit),
      static_cast<const float*>(g_phi), static_cast<const float*>(g_emit),
      static_cast<float*>(dlp), T, B, K, N, blank, C);
  return cudaGetLastError();
}
