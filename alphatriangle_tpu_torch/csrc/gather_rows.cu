// Batched row gather for the MCTS descent: out[b, j, :] = stats[b, idx[b, j], :].
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/gather_rows.py::_gather_kernel`
// (launched by `gather_rows_pallas`), which streamed each game's whole (N, K)
// stat block into VMEM and copied W rows out of it.
//
// Bound on Hopper: bytes. The function moves the W selected rows of K floats
// per game in and out (2 * B * W * K * 4 bytes at most) and does no
// arithmetic, so it is a pure copy. Design: one block per (b, j) output row,
// each thread moving 16-byte float4 words with neighbouring threads on
// neighbouring addresses; only the rows the descent selects are read (the
// Pallas kernel's whole-block load would read all N rows). A scalar path
// covers K that is not a multiple of 4 or a base that is not 16-byte aligned.
// An index outside [0, N) trips a device-side assert, which surfaces as a
// CUDA error at the caller's next synchronisation.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const float* __restrict__ stats,
                                   const int64_t* __restrict__ idx,
                                   float* __restrict__ out, int n, int w, int k,
                                   int vec) {
  const int64_t bw = blockIdx.x;  // b * w + j
  const int64_t b = bw / w;
  const int64_t row = idx[bw];
  assert(row >= 0 && row < n);
  const float* src = stats + (b * n + row) * k;
  float* dst = out + bw * k;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < k / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < k; i += blockDim.x) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int gather_rows_launch(const float* stats, const int64_t* idx, float* out,
                                  int b, int n, int w, int k, int vec, void* stream) {
  if (b * w == 0 || k == 0) return 0;
  gather_rows_kernel<<<b * w, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      stats, idx, out, n, w, k, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
