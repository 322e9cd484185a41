// CTC forward (alpha) recursion and per-sequence loss for Hopper (sm_90a).
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_ctc_fwd_kernel
// (launched by _ctc_pallas_fwd, reached through ctc_alpha_loss /
// pallas_ctc_loss from mgr_tpu/ops/ctc.py::ctc_loss_from_logits) together
// with its epilogue _ctc_final_loss. Same function, on the packed state
// of N+1 columns per sequence (emit in cols 0..N-1, phi in cols 0..N):
//
//   shift[n] = n == 0 ? NEG : emit[n-1]
//   emit'[n] = lse(lse(emit[n], phi[n]), shift[n] + skip[n]) + lp[t, label[n]]
//   phi'[n]  = lse(phi[n], shift[n]) + lp[t, blank]
//   skip[n]  = NEG where n == 0 or label[n] == label[n-1], else 0
//   carries frozen for t >= input_length;  NEG = -1e5 (not -inf)
//   loss     = -lse(phi[L], L > 0 ? emit[L-1] : NEG)
//
// Inputs: log_probs (T, B, K) f32 time-major; labels (B, N) int32, padded
// with -1 (read as 0, as the JAX package does; a label >= K scores 0, as
// its one-hot packing does); input_lengths,
// label_lengths (B,) int32. Output: loss (B,) f32 and, when the training
// path asks for them (non-null pointers), the post-step alphas of every
// frame, time-major like the input: alpha_phi (T, B, N+1) and alpha_emit
// (T, B, N) f32, frozen for t >= input_length as the TPU kernel writes
// a_next / p_next. The CTC backward kernel (ctc_bwd.cu) reads them.
//
// What bounds it on this card: T dependent steps of a few transcendental
// functions per column, and the latency of each step's read of the
// emission scores. There is almost no arithmetic and little data
// (T*B*K*4 bytes = 43 MB at the speech shapes, read once).
//
// Design: sequences are independent, so one block per sequence and one
// thread per lattice column n in [0, N], the block rounded up to whole
// warps (N = 150 gives 160 threads); nothing is shared between blocks.
// The TPU packed emission scores with a one-hot matmul outside its kernel
// (pallas_kernels.py:719-731) because it cannot gather inside one; here
// each thread reads lp[t, b, label[n]] and the blank score straight from
// the time-major log-probs (the row of K floats stays in L1), one step
// ahead so the load's latency hides behind the current step. The only
// cross-thread dependency, emit[n-1], goes through a double-buffered
// shared array with one __syncthreads per step. The alpha store adds two
// coalesced f32 stores per column per step (73 MB at B=32, T'=1898,
// N=150); the eval path passes null pointers and stores nothing.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e5f;

// jnp.logaddexp for finite inputs: max + log1p(exp(-|x - y|)).
__device__ __forceinline__ float lse(float x, float y) {
  return fmaxf(x, y) + log1pf(expf(-fabsf(x - y)));
}

__global__ void ctc_fwd_kernel(const float* __restrict__ log_probs,
                               const int* __restrict__ labels,
                               const int* __restrict__ input_lengths,
                               const int* __restrict__ label_lengths,
                               float* __restrict__ loss,
                               float* __restrict__ alpha_phi,
                               float* __restrict__ alpha_emit,
                               int T, int B, int K, int N, int blank) {
  extern __shared__ float emit_s[];  // [2][N + 1]
  const int b = blockIdx.x;
  const int n = threadIdx.x;
  const int W = N + 1;
  const bool column = n <= N;
  const bool emit_col = n < N;

  int label = blank;
  float skip = 0.0f;
  if (emit_col) {
    const int* lab = labels + (size_t)b * N;
    label = max(lab[n], 0);
    skip = (n == 0 || label == max(lab[n - 1], 0)) ? NEG : 0.0f;
  }
  const int len = min(input_lengths[b], T);
  const size_t step = (size_t)B * K;
  const float* row = log_probs + (size_t)b * K;

  float emit = NEG;
  float phi = n == 0 ? 0.0f : NEG;
  float lp_e = NEG, lp_b = NEG;
  if (column && len > 0) {
    lp_e = label < K ? row[label] : 0.0f;
    lp_b = row[blank];
  }
  int buf = 0;
  for (int t = 0; t < len; ++t) {
    const float cur_e = lp_e, cur_b = lp_b;
    if (column && t + 1 < len) {
      const float* next = row + (size_t)(t + 1) * step;
      lp_e = label < K ? next[label] : 0.0f;
      lp_b = next[blank];
    }
    if (column) emit_s[buf * W + n] = emit;
    __syncthreads();
    if (column) {
      const float shift = n == 0 ? NEG : emit_s[buf * W + n - 1];
      const float new_emit = emit_col ? lse(lse(emit, phi), shift + skip) + cur_e : NEG;
      phi = lse(phi, shift) + cur_b;
      emit = new_emit;
      if (alpha_phi != nullptr) {
        alpha_phi[((size_t)t * B + b) * W + n] = phi;
        if (emit_col) alpha_emit[((size_t)t * B + b) * N + n] = emit;
      }
    }
    buf ^= 1;
  }
  if (alpha_phi != nullptr && column) {  // frozen carries past the length
    for (int t = len; t < T; ++t) {
      alpha_phi[((size_t)t * B + b) * W + n] = phi;
      if (emit_col) alpha_emit[((size_t)t * B + b) * N + n] = emit;
    }
  }

  __syncthreads();  // the last step's readers are done with emit_s
  if (column) {
    emit_s[n] = emit;
    emit_s[W + n] = phi;
  }
  __syncthreads();
  if (n == 0) {
    const int L = min(max(label_lengths[b], 0), N);
    const float phi_end = emit_s[W + L];
    const float emit_end = L > 0 ? emit_s[L - 1] : NEG;
    loss[b] = -lse(phi_end, emit_end);
  }
}

}  // namespace

extern "C" const char* ctc_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches B blocks of ceil32(N + 1) threads on `stream`; returns the
// cudaError_t of the launch. alpha_phi / alpha_emit are both null (loss
// only) or both set (store the alphas).
extern "C" int ctc_fwd(const void* log_probs, const void* labels,
                       const void* input_lengths, const void* label_lengths,
                       void* loss, void* alpha_phi, void* alpha_emit,
                       int T, int B, int K, int N, int blank,
                       int device, void* stream) {
  if (T < 0 || B <= 0 || K <= 0 || N < 0 || N + 1 > 1024 || blank < 0 || blank >= K ||
      (alpha_phi == nullptr) != (alpha_emit == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int threads = ((N + 1 + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)(N + 1) * sizeof(float);
  ctc_fwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int*>(labels),
      static_cast<const int*>(input_lengths), static_cast<const int*>(label_lengths),
      static_cast<float*>(loss), static_cast<float*>(alpha_phi),
      static_cast<float*>(alpha_emit), T, B, K, N, blank);
  return cudaGetLastError();
}
