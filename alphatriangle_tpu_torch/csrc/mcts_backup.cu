// Fused MCTS edge-plane update, in place: W child insertions, then the W x D
// visit/return backup adds along the recorded descent paths.
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/mcts_backup.py::_backup_kernel`
// (launched by `backup_update_pallas`), which held a game's four (N, A) planes
// in VMEM and applied every update as a one-hot row read-modify-write. Four
// flagship planes are ~374 KB per game, more than an SM's shared memory, so
// this kernel leaves the planes in device memory and touches only the
// W * (D + 1) addressed elements.
//
// Bound on Hopper: launch latency. A wave moves a few KB per game; the work
// is one block per game, so the kernel is as short as one launch can be.
//
// Semantics (bit parity with the XLA scatter chain, `backup_update_xla`):
// - children[p, a] = max over the old value and every member's new_child
//   for that edge (order-free); the first member of each distinct edge
//   computes it and writes once.
// - e_reward[p, a] = rewards[j] of the LAST member j with that edge (.set
//   where the last write wins).
// - Each (level, member) entry targets (max(node, 0), max(action, 0)) and adds
//   1.0 / its return when active, +0.0 / +0.0 when not. Entries are staged in
//   shared memory in (level ascending, member ascending) order; the first
//   entry of each distinct element sums every entry with that element, in that
//   order, onto the plane value in a register and writes once. No atomics:
//   their order varies from run to run, and the float sums would too.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void backup_update_kernel(float* __restrict__ visits, float* __restrict__ value,
                                     float* __restrict__ children, float* __restrict__ reward,
                                     const int64_t* __restrict__ parents,
                                     const int64_t* __restrict__ actions,
                                     const float* __restrict__ new_child,
                                     const float* __restrict__ rewards,
                                     const int64_t* __restrict__ rec_node,
                                     const int64_t* __restrict__ rec_action,
                                     const uint8_t* __restrict__ rec_active,
                                     const float* __restrict__ returns, int n, int a, int w,
                                     int d) {
  extern __shared__ int smem[];
  const int entries = w * d;
  int* s_key = smem;                                      // (entries,) flat n * a + a
  float* s_cnt = reinterpret_cast<float*>(s_key + entries);  // (entries,)
  float* s_val = s_cnt + entries;                            // (entries,)
  int* s_ins = reinterpret_cast<int*>(s_val + entries);      // (w,) insertion keys

  const int64_t b = blockIdx.x;
  const int64_t plane = b * n * a;

  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int lvl = e / w;
    const int j = e % w;
    const int64_t src = (b * w + j) * d + lvl;
    const int64_t nd = rec_node[src] > 0 ? rec_node[src] : 0;
    const int64_t ac = rec_action[src] > 0 ? rec_action[src] : 0;
    assert(nd < n && ac < a);
    const bool active = rec_active[src] != 0;
    s_key[e] = static_cast<int>(nd * a + ac);
    s_cnt[e] = active ? 1.0f : 0.0f;
    s_val[e] = active ? returns[src] : 0.0f;
  }
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const int64_t p = parents[b * w + j];
    const int64_t ac = actions[b * w + j];
    assert(p >= 0 && p < n && ac >= 0 && ac < a);
    s_ins[j] = static_cast<int>(p * a + ac);
  }
  __syncthreads();

  // Insertion: children max (first member of the edge), reward set (last).
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const int key = s_ins[j];
    bool first = true;
    bool last = true;
    for (int k = 0; k < j; ++k) first = first && s_ins[k] != key;
    for (int k = j + 1; k < w; ++k) last = last && s_ins[k] != key;
    if (first) {
      float m = children[plane + key];
      for (int k = j; k < w; ++k) {
        if (s_ins[k] == key) m = fmaxf(m, new_child[b * w + k]);
      }
      children[plane + key] = m;
    }
    if (last) reward[plane + key] = rewards[b * w + j];
  }

  // Backup: one ordered sum per distinct (node, action) element.
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int key = s_key[e];
    bool first = true;
    for (int k = 0; k < e && first; ++k) first = s_key[k] != key;
    if (!first) continue;
    float v = visits[plane + key];
    float q = value[plane + key];
    for (int k = e; k < entries; ++k) {
      if (s_key[k] == key) {
        v += s_cnt[k];
        q += s_val[k];
      }
    }
    visits[plane + key] = v;
    value[plane + key] = q;
  }
}

}  // namespace

extern "C" int backup_update_shared_bytes(int w, int d) {
  return w * d * 3 * static_cast<int>(sizeof(float)) + w * static_cast<int>(sizeof(int));
}

extern "C" int backup_update_launch(float* visits, float* value, float* children, float* reward,
                                    const int64_t* parents, const int64_t* actions,
                                    const float* new_child, const float* rewards,
                                    const int64_t* rec_node, const int64_t* rec_action,
                                    const uint8_t* rec_active, const float* returns, int b,
                                    int n, int a, int w, int d, void* stream) {
  if (b == 0 || w == 0) return 0;
  const int shared = backup_update_shared_bytes(w, d);
  backup_update_kernel<<<b, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      visits, value, children, reward, parents, actions, new_child, rewards, rec_node,
      rec_action, rec_active, returns, n, a, w, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* backup_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
