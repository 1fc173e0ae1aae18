// Stratified PER draw, the count: out[q] = #{i : cum[i] < u[q]}.
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/per_sample.py::_count_below_kernel`
// (launched by `count_below_pallas`), which kept the whole cumsum of the
// priorities in VMEM and streamed it in 512-wide tiles past each step row's
// B stratum draws, one grid program per step row.
//
// Bound on Hopper: the function compares every query with every element,
// K * B * n float compares (128 M at the flagship, K = 2, B = 256,
// n = 250,000), against 1 MB of cumsum. That is a few microseconds of the
// card's float32 rate and well under one of its memory rate, so the
// compares bound it; at one launch per megastep either is far below the
// megastep. Design: the grid covers (chunk of cum, block of queries). Each
// block stages its chunk of `cum` in shared memory (padded with +inf, which
// no query counts), each thread holds one query in a register and counts the
// chunk's elements below it with 16-byte shared-memory reads (all threads of
// a warp read the same address, a broadcast). The chunks' partial counts are
// summed with integer atomicAdd into an output the wrapper zeroes: integer
// sums are exact in any order, so the result equals the plain count on any
// input, sorted or not (a binary search would equal it only on a
// nondecreasing `cum`).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kChunk = 2048;   // cum elements staged per block (8 KB)

__global__ void per_sample_kernel(const float* __restrict__ cum, const float* __restrict__ u,
                                  int* __restrict__ out, int n, int q) {
  __shared__ __align__(16) float tile[kChunk];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    tile[i] = base + i < n ? cum[base + i] : __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();
  const int qi = blockIdx.y * kThreads + threadIdx.x;
  if (qi >= q) return;
  const float v = u[qi];
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  int count = 0;
#pragma unroll 8
  for (int i = 0; i < kChunk / 4; ++i) {
    const float4 c = t4[i];
    count += (c.x < v) + (c.y < v) + (c.z < v) + (c.w < v);
  }
  if (count) atomicAdd(out + qi, count);
}

}  // namespace

extern "C" int count_below_launch(const float* cum, const float* u, int* out, int n, int q,
                                  void* stream) {
  if (n == 0 || q == 0) return 0;
  const dim3 grid((n + kChunk - 1) / kChunk, (q + kThreads - 1) / kThreads);
  per_sample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cum, u, out, n, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* per_sample_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
