// CTC forward (alpha) recursion and per-sequence loss for Hopper (sm_90a).
//
// Replaces the TPU kernel mgr_tpu/ops/pallas_kernels.py:_ctc_fwd_kernel
// (launched by _ctc_pallas_fwd, reached through ctc_alpha_loss /
// pallas_ctc_loss from mgr_tpu/ops/ctc.py::ctc_loss_from_logits) together
// with its epilogue _ctc_final_loss. Same function, on the packed state
// of N+1 columns per sequence (emit in cols 0..N-1, phi in cols 0..N):
//
//   shift[n] = n == 0 ? NEG : emit[n-1]
//   emit'[n] = lse(emit[n], phi[n], shift[n] + skip[n]) + lp[t, label[n]]
//   phi'[n]  = lse(phi[n], shift[n]) + lp[t, blank]
//   skip[n]  = NEG where n == 0 or label[n] == label[n-1], else 0
//   carries frozen for t >= input_length;  NEG = -1e5 (not -inf)
//   loss     = -lse(phi[L], L > 0 ? emit[L-1] : NEG)
//
// Inputs: log_probs (T, B, K) f32 time-major; labels (B, N) int32, padded
// with -1 (read as 0, as the JAX package does; a label >= K scores 0, as
// its one-hot packing does); input_lengths, label_lengths (B,) int32.
// Output: loss (B,) f32 and, when the training path asks for them
// (alpha_phi non-null), the post-step alphas of every frame, time-major
// like the input: alpha_phi (T, B, N+1) and alpha_emit (T, B, N) f32,
// frozen for t >= input_length as the TPU kernel writes a_next / p_next.
// Their rows are alpha_pitch(w) floats apart (w rounded up to a multiple
// of 4, ctc_common.cuh), so that the CTC backward kernel (ctc_bwd.cu),
// which reads them, stages each row with one bulk copy.
//
// What bounds it on this card: the serial chain of a step, T steps long.
// The data are small (T*B*K*4 bytes = 43 MB at B=128, T'=1898, K=44, read
// once; the alpha store writes 73 MB at B=32), so the bound by bytes is
// far below the chain: a shared load of emit[n-1], the emit update's two
// exponentials and one logarithm, and one block barrier per step.
//
// Design: sequences are independent, so one block per sequence and one
// thread per lattice column n in [0, N], rounded up to whole warps (N = 150
// gives 160 threads); nothing is shared between blocks.
//   - No device-memory load on the chain. The TPU packed the emission
//     scores with a one-hot matmul outside its kernel (pallas_kernels.py:
//     719-731) because it cannot gather inside one. Here the block stages
//     chunks of C log-prob rows (K floats each) into a ring of STAGES = 4
//     chunks in shared memory with 4-byte cp.async.ca copies (any K, any
//     alignment), STAGES - 1 = 3 chunks ahead of use; it waits
//     (cp.async.wait_group) and syncs only at chunk boundaries. Each column
//     then gathers lp[t, label[n]] and the blank's score from shared memory.
//     C = min(16, max(1, 64 KiB / (STAGES * 4K))): 16 at K = 44, fewer
//     where K is wide; dynamic shared memory above 48 KB is opted in to
//     once per device.
//   - A short chain. The emit update is one three-way log-sum-exp: the
//     largest of the three plus the log of a sum in [1, 3] (two
//     exponentials, one logarithm), where lse(lse(emit, phi), shift+skip)
//     took two of each. The phi update stays a two-way log-sum-exp. Both
//     use the fast intrinsics __expf and __logf (ex2.approx / lg2.approx):
//     every argument of __expf is <= 0 and every argument of __logf is in
//     [1, 3], where their absolute error is a few 1e-7, inside the
//     tolerance against the plain version (1e-4 relative to max(1, |x|),
//     loss and alphas, at T' = 1898).
//   - The only cross-thread dependency, emit[n-1], goes through a
//     double-buffered shared array with one __syncthreads per step.
//   - The alpha store: two coalesced f32 stores per column per step,
//     fire-and-forget, off the chain; the eval path passes null pointers
//     and stores nothing.

#include <cuda_runtime.h>

#include "ctc_common.cuh"

namespace {

using namespace ctc;

constexpr int STAGES = 4;                 // chunks in the log-prob ring
constexpr size_t RING_BYTES = 64 * 1024;  // the ring's budget, which sets C

int chunk_frames(int K) {
  const size_t c = RING_BYTES / ((size_t)STAGES * K * sizeof(float));
  return (int)(c < 1 ? 1 : (c > (size_t)CHUNK_MAX ? CHUNK_MAX : c));
}

size_t smem_bytes(int N, int K, int C) {
  return (2 * (size_t)(N + 1) + (size_t)STAGES * C * K) * sizeof(float);
}

// log(e^a + e^b) for finite a, b.
__device__ __forceinline__ float lse2(float a, float b) {
  return fmaxf(a, b) + __logf(1.0f + __expf(-fabsf(a - b)));
}

// log(e^a + e^b + e^c): the largest plus the log of a sum in [1, 3]; the
// median max(min(a, b), min(max(a, b), c)) is one of the three, exactly.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float hi = fmaxf(fmaxf(a, b), c);
  const float lo = fminf(fminf(a, b), c);
  const float mid = fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
  return hi + __logf(1.0f + __expf(mid - hi) + __expf(lo - hi));
}

__global__ void __launch_bounds__(MAX_THREADS)
    ctc_fwd_kernel(const float* __restrict__ log_probs, const int* __restrict__ labels,
                   const int* __restrict__ input_lengths,
                   const int* __restrict__ label_lengths, float* __restrict__ loss,
                   float* __restrict__ alpha_phi, float* __restrict__ alpha_emit, int T,
                   int B, int K, int N, int blank, int C) {
  // Shared memory: emit_s [2][W] | ring [STAGES][C][K].
  extern __shared__ float smem[];
  const int W = N + 1;
  const int Wp = alpha_pitch(W), Np = alpha_pitch(N);
  float* emit_s = smem;
  float* ring = smem + 2 * W;

  const int b = blockIdx.x;
  const int n = threadIdx.x;
  const bool column = n <= N;
  const bool emit_col = n < N;

  int label = blank;
  float skip = 0.0f;
  if (emit_col) column_label(labels + (size_t)b * N, n, &label, &skip);
  const bool scored = label < K;
  const int len = max(min(input_lengths[b], T), 0);
  const int chunks = (len + C - 1) / C;
  const float* src = log_probs + (size_t)b * K;  // frame t's row at src + t * B * K
  const size_t frame = (size_t)B * K;

  // Chunk c (frames c*C .. ) into ring stage c % STAGES; one commit group
  // per call, empty past the last chunk, so every thread counts the same.
  auto stage = [&](int c) {
    if (c < chunks) {
      const int t0 = c * C, rows = min(C, len - t0);
      float* dst = ring + (size_t)(c % STAGES) * C * K;
      for (int i = n; i < rows * K; i += blockDim.x) {
        const int r = i / K;
        cp_async4(dst + i, src + (size_t)(t0 + r) * frame + (i - r * K));
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < STAGES - 1; ++c) stage(c);
  float emit = NEG;
  float phi = n == 0 ? 0.0f : NEG;
  int buf = 0;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's; and chunk c-1's stage is free
    stage(c + STAGES - 1);
    const float* chunk = ring + (size_t)(c % STAGES) * C * K;
    const int t0 = c * C, t1 = min(t0 + C, len);
    for (int t = t0; t < t1; ++t) {
      const float* row = chunk + (t - t0) * K;
      if (column) emit_s[buf * W + n] = emit;
      __syncthreads();
      if (column) {
        const float lp_e = scored ? row[label] : 0.0f;
        const float lp_b = row[blank];
        const float shift = n == 0 ? NEG : emit_s[buf * W + n - 1];
        const float new_emit = emit_col ? lse3(emit, phi, shift + skip) + lp_e : NEG;
        phi = lse2(phi, shift) + lp_b;
        emit = new_emit;
        if (alpha_phi != nullptr) {
          alpha_phi[((size_t)t * B + b) * Wp + n] = phi;
          if (emit_col) alpha_emit[((size_t)t * B + b) * Np + n] = emit;
        }
      }
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  if (alpha_phi != nullptr && column) {  // frozen carries past the length
    for (int t = len; t < T; ++t) {
      alpha_phi[((size_t)t * B + b) * Wp + n] = phi;
      if (emit_col) alpha_emit[((size_t)t * B + b) * Np + n] = emit;
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
    loss[b] = -lse2(phi_end, emit_end);
  }
}

}  // namespace

extern "C" const char* ctc_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch K3 makes for N labels and K classes: threads per block, frames
// per staged chunk and dynamic shared memory in bytes.
extern "C" int ctc_fwd_launch_shape(int N, int K, int* threads, int* chunk, int* smem) {
  if (N < 0 || N + 1 > MAX_THREADS || K <= 0) return cudaErrorInvalidValue;
  *threads = block_threads(N);
  *chunk = chunk_frames(K);
  *smem = (int)smem_bytes(N, K, *chunk);
  return cudaSuccess;
}

// Launches B blocks of ceil32(N + 1) threads on `stream`; returns the
// cudaError_t of the launch. alpha_phi null: loss only; else alpha_phi
// (T, B, alpha_pitch(N + 1)) and (where N > 0) alpha_emit
// (T, B, alpha_pitch(N)) receive the alphas in their first N + 1 / N
// columns.
extern "C" int ctc_fwd(const void* log_probs, const void* labels,
                       const void* input_lengths, const void* label_lengths,
                       void* loss, void* alpha_phi, void* alpha_emit,
                       int T, int B, int K, int N, int blank,
                       int device, void* stream) {
  if (T < 0 || B <= 0 || K <= 0 || N < 0 || N + 1 > MAX_THREADS || blank < 0 || blank >= K ||
      (alpha_phi == nullptr && alpha_emit != nullptr) ||
      (alpha_phi != nullptr && N > 0 && alpha_emit == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int C = chunk_frames(K);
  const size_t smem = smem_bytes(N, K, C);
  err = allow_smem(reinterpret_cast<const void*>(ctc_fwd_kernel), device, smem);
  if (err != cudaSuccess) return err;
  ctc_fwd_kernel<<<B, block_threads(N), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int*>(labels),
      static_cast<const int*>(input_lengths), static_cast<const int*>(label_lengths),
      static_cast<float*>(loss), static_cast<float*>(alpha_phi),
      static_cast<float*>(alpha_emit), T, B, K, N, blank, C);
  return cudaGetLastError();
}
