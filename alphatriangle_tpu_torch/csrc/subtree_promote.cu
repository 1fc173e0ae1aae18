// Subtree-reuse row reorder of the six edge planes:
//   out_p[b, r, :] = in_p[b, order[b, r], :]  for r < retained[b],
//   out_p[b, r, :] = fill_p                   otherwise
// (fill 0, or -1 for the children plane, plane 3).
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/subtree_reuse.py::_promote_kernel`
// (launched by `_reorder_planes_pallas`), which ran one grid program per game
// and walked that game's N rows in a sequential loop, holding all six (N, A)
// planes in VMEM.
//
// Bound on Hopper: bytes. The function reads the retained rows of six planes
// once, writes every row of six planes once and reads the order; it does no
// arithmetic, so it is a pure copy. Design: output rows are independent, so
// the grid covers the (B, N) output rows, one block each, instead of the
// Pallas per-game loop. A block reads its source row id and whether the row
// is kept once, then writes the row of all six planes, copying from row
// `order[b, r]` or storing the fill without reading anything. Threads move
// 16-byte float4 words, neighbouring threads on neighbouring addresses; a
// scalar path covers A that is not a multiple of 4 or a pointer that is not
// 16-byte aligned. A kept row whose source lies outside [0, N) trips a
// device-side assert, which surfaces as a CUDA error at the caller's next
// synchronisation.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPlanes = 6;
constexpr int kChildrenPlane = 3;

struct Planes {
  const float* in[kPlanes];
  float* out[kPlanes];
};

__global__ void subtree_promote_kernel(const int64_t* __restrict__ order,
                                       const int32_t* __restrict__ retained, Planes p,
                                       int n, int a, int vec) {
  const int64_t row = blockIdx.x;  // b * n + r
  const int64_t b = row / n;
  const int r = static_cast<int>(row - b * n);
  const bool take = r < retained[b];
  int64_t src = 0;
  if (take) {
    src = order[row];
    assert(src >= 0 && src < n);
  }
  const int64_t in_off = (b * n + src) * a;
  const int64_t out_off = row * a;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    const float fill = q == kChildrenPlane ? -1.0f : 0.0f;
    float* dst = p.out[q] + out_off;
    if (vec) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      if (take) {
        const float4* s4 = reinterpret_cast<const float4*>(p.in[q] + in_off);
        for (int i = threadIdx.x; i < a / 4; i += blockDim.x) d4[i] = s4[i];
      } else {
        const float4 f4 = make_float4(fill, fill, fill, fill);
        for (int i = threadIdx.x; i < a / 4; i += blockDim.x) d4[i] = f4;
      }
    } else {
      if (take) {
        const float* s = p.in[q] + in_off;
        for (int i = threadIdx.x; i < a; i += blockDim.x) dst[i] = s[i];
      } else {
        for (int i = threadIdx.x; i < a; i += blockDim.x) dst[i] = fill;
      }
    }
  }
}

}  // namespace

extern "C" int subtree_promote_launch(const int64_t* order, const int32_t* retained,
                                      const float* in0, const float* in1, const float* in2,
                                      const float* in3, const float* in4, const float* in5,
                                      float* out0, float* out1, float* out2, float* out3,
                                      float* out4, float* out5, int b, int n, int a, int vec,
                                      void* stream) {
  if (b * n == 0 || a == 0) return 0;
  Planes p{{in0, in1, in2, in3, in4, in5}, {out0, out1, out2, out3, out4, out5}};
  subtree_promote_kernel<<<b * n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      order, retained, p, n, a, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subtree_promote_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
