// Shared by ctc_fwd.cu (K3) and ctc_bwd.cu (K4): the lattice's log-epsilon,
// the block shape (one thread per lattice column), the row pitch of the
// stored alphas, a column's label and skip penalty, and the opt-in to
// dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

#include "async_copy.cuh"

namespace ctc {

constexpr float NEG = -1.0e5f;     // the reference's log-epsilon, not -inf
constexpr int MAX_THREADS = 1024;  // one thread per column n in [0, N]
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int CHUNK_MAX = 16;      // frames per staged chunk

// Threads of a block: the N + 1 columns rounded up to whole warps.
inline int block_threads(int N) { return ((N + 1 + 31) / 32) * 32; }

// Floats between two rows of a stored alpha array of width w (N + 1 for
// alpha_phi, N for alpha_emit): w rounded up to a multiple of 4, so that
// every row starts 16-byte aligned and K4 stages it with one bulk copy.
__host__ __device__ inline int alpha_pitch(int w) { return (w + 3) & ~3; }

// Column n's class (a -1 pad reads as class 0, as the JAX package reads it)
// and its skip penalty: NEG at column 0 and where the label repeats the one
// before it (the direct emit[n-1] -> emit[n] step is forbidden), else 0.
__device__ __forceinline__ void column_label(const int* lab, int n, int* label, float* skip) {
  *label = max(lab[n], 0);
  *skip = (n == 0 || *label == max(lab[n - 1], 0)) ? NEG : 0.0f;
}

// Raise `kernel`'s dynamic shared-memory limit once per device to the most
// a block may opt in to (a limit is state of the function: lowering it for a
// narrow launch broke a later, wider one with error 720), and refuse a
// launch that needs more.
inline cudaError_t allow_smem(const void* kernel, int device, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> optin;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, device);
  auto it = optin.find(key);
  if (it == optin.end()) {
    int limit = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    it = optin.emplace(key, limit).first;
  }
  return smem <= (size_t)it->second ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ctc
