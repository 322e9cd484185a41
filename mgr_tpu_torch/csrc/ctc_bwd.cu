// CTC backward: the exact adjoint of the alpha recursion, for Hopper (sm_90a).
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_ctc_bwd_kernel
// (launched by _ctc_pallas_bwd from the custom VJP _ctc_alpha_loss_bwd of
// pallas_ctc_loss). Same function, walking time in reverse over the
// post-step alphas that ctc_fwd.cu stored (alpha_phi (T, B, N+1), alpha_emit
// (T, B, N) f32, time-major), on the state of N+1 lattice columns:
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
// the one-hot packing einsum scatter it back to the K classes. Here each
// step sums its columns into a row of K floats in shared memory (shared
// atomics: repeated labels map several columns to one class and must add,
// not overwrite), adds the blank's sum, and writes the row once, coalesced.
// That skips a (T, B, N+1) intermediate (37 MB at the speech shapes) and a
// scatter pass over it.
//
// What bounds it on this card: like the forward, T dependent steps of a
// few exp per column, each waiting on the latency of its loads of the
// stored alphas (about 2 x 37 MB read once at B=32, T'=1898, N=150). Very
// little arithmetic and no reuse.
//
// Design: one block per sequence and one thread per lattice column, as in
// ctc_fwd.cu; nothing is shared between blocks. A column's adjoints stay in
// registers. The only exchanges within a step are the left shift of dsa and
// des (the adjoint of the forward's right shift), through double-buffered
// shared arrays, and the blank's sum, a warp-shuffle reduction then a small
// shared array. One __syncthreads per step. The post-step alphas of t are
// the pre-step alphas of t+1, so each step loads one row of alphas and
// carries the other. Later work: prefetch a step ahead, several sequences
// per block at small N.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e5f;
constexpr int MAX_WARPS = 32;

__global__ void ctc_bwd_kernel(const float* __restrict__ log_probs,
                               const int* __restrict__ labels,
                               const int* __restrict__ input_lengths,
                               const int* __restrict__ label_lengths,
                               const float* __restrict__ alpha_phi,
                               const float* __restrict__ alpha_emit,
                               const float* __restrict__ g_phi,
                               const float* __restrict__ g_emit,
                               float* __restrict__ dlp,
                               int T, int B, int K, int N, int blank) {
  // Shared memory: dsa_s [2][W+1] | des_s [2][W+1] | red_s [2][MAX_WARPS] | row_s [2][K].
  extern __shared__ float smem[];
  const int W = N + 1;
  float* dsa_s = smem;
  float* des_s = dsa_s + 2 * (W + 1);
  float* red_s = des_s + 2 * (W + 1);
  float* row_s = red_s + 2 * MAX_WARPS;

  const int b = blockIdx.x;
  const int n = threadIdx.x;
  const int lane = n & 31, warp = n >> 5;
  const bool column = n <= N;
  const bool emit_col = n < N;

  int label = blank;
  float skip = 0.0f;
  if (emit_col) {
    const int* lab = labels + (size_t)b * N;
    label = max(lab[n], 0);
    skip = (n == 0 || label == max(lab[n - 1], 0)) ? NEG : 0.0f;
  }
  const int len = max(min(input_lengths[b], T), 0);
  const int L = min(max(label_lengths[b], 0), N);

  // Frames past the length: exactly zero.
  for (int i = n; i < (T - len) * K; i += blockDim.x) {
    const int t = len + i / K;
    dlp[((size_t)t * B + b) * K + i % K] = 0.0f;
  }
  for (int i = n; i < 2 * (W + 1); i += blockDim.x) dsa_s[i] = des_s[i] = 0.0f;
  for (int i = n; i < 2 * K; i += blockDim.x) row_s[i] = 0.0f;

  float demit = (emit_col && L > 0 && n == L - 1) ? g_emit[b] : 0.0f;
  float dphi = (column && n == L) ? g_phi[b] : 0.0f;

  const size_t se = (size_t)B * N;  // alpha_emit stride per frame
  const size_t sp = (size_t)B * W;  // alpha_phi stride per frame
  const float* ae = alpha_emit + (size_t)b * N;
  const float* ap = alpha_phi + (size_t)b * W;
  float e_cur = NEG, p_cur = NEG;
  if (len > 0) {
    if (emit_col) e_cur = ae[(size_t)(len - 1) * se + n];
    if (column) p_cur = ap[(size_t)(len - 1) * sp + n];
  }
  __syncthreads();

  int buf = 0;
  for (int t = len - 1; t >= 0; --t) {
    float e_prev = NEG, p_prev = n == 0 ? 0.0f : NEG, e_left = NEG;
    if (t > 0) {
      const size_t tp = (size_t)(t - 1);
      if (emit_col) e_prev = ae[tp * se + n];
      if (column) p_prev = ap[tp * sp + n];
      if (column && n > 0) e_left = ae[tp * se + n - 1];
    }
    const float* row = log_probs + ((size_t)t * B + b) * K;
    const float shift = n == 0 ? NEG : e_left;

    float w_a = 0.0f, w_p = 0.0f, dsa = 0.0f, w_pp = 0.0f, des = 0.0f;
    if (emit_col) {
      const float lp_e = label < K ? row[label] : 0.0f;
      const float ye = e_cur - lp_e;
      w_a = expf(e_prev - ye);
      w_p = expf(p_prev - ye);
      dsa = demit * expf(shift + skip - ye);
      if (label < K) atomicAdd(&row_s[buf * K + label], demit);
    }
    if (column) {
      const float yp = p_cur - row[blank];
      w_pp = expf(p_prev - yp);
      des = dphi * expf(shift - yp);
      dsa_s[buf * (W + 1) + n] = dsa;
      des_s[buf * (W + 1) + n] = des;
    }
    float sum = column ? dphi : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) red_s[buf * MAX_WARPS + warp] = sum;
    __syncthreads();

    float demit_prev = 0.0f, dphi_prev = 0.0f;
    if (emit_col) {
      demit_prev = demit * w_a + dsa_s[buf * (W + 1) + n + 1];
      demit_prev = demit_prev + des_s[buf * (W + 1) + n + 1];
    }
    if (column) dphi_prev = demit * w_p + dphi * w_pp;
    for (int k = n; k < K; k += blockDim.x) {
      float v = row_s[buf * K + k];
      if (k == blank) {
        float s = 0.0f;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red_s[buf * MAX_WARPS + w];
        v += s;
      }
      dlp[((size_t)t * B + b) * K + k] = v;
      row_s[buf * K + k] = 0.0f;  // ready again two steps on
    }
    demit = demit_prev;
    dphi = dphi_prev;
    e_cur = e_prev;
    p_cur = p_prev;
    buf ^= 1;
  }
}

}  // namespace

extern "C" const char* ctc_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches B blocks of ceil32(N + 1) threads on `stream`; returns the
// cudaError_t of the launch. g_phi, g_emit (B,) f32 are the loss's seeds
// at phi[L] and emit[L-1]; dlp (T, B, K) f32 is written in full.
extern "C" int ctc_bwd(const void* log_probs, const void* labels,
                       const void* input_lengths, const void* label_lengths,
                       const void* alpha_phi, const void* alpha_emit,
                       const void* g_phi, const void* g_emit, void* dlp,
                       int T, int B, int K, int N, int blank,
                       int device, void* stream) {
  if (T < 0 || B <= 0 || K <= 0 || N < 0 || N + 1 > 32 * MAX_WARPS || blank < 0 ||
      blank >= K)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int threads = ((N + 1 + 31) / 32) * 32;
  const size_t smem = (4 * (size_t)(N + 2) + 2 * MAX_WARPS + 2 * (size_t)K) * sizeof(float);
  ctc_bwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int*>(labels),
      static_cast<const int*>(input_lengths), static_cast<const int*>(label_lengths),
      static_cast<const float*>(alpha_phi), static_cast<const float*>(alpha_emit),
      static_cast<const float*>(g_phi), static_cast<const float*>(g_emit),
      static_cast<float*>(dlp), T, B, K, N, blank);
  return cudaGetLastError();
}
