// Stratified PER draw, the count: out[q] = #{i : cum[i] < u[q]}.
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/per_sample.py::_count_below_kernel`
// (launched by `count_below_pallas`), which kept the whole cumsum of the
// priorities in VMEM and streamed it in 512-wide tiles past each step row's
// B stratum draws, one grid program per step row.
//
// Bound on Hopper: bytes. The function needs the cumsum read once (1 MB at
// the flagship, n = 250,000) and K * B = 512 draws read and counts written:
// 0.30 us at 3.35 TB/s. Comparing every draw with every element (128 M
// compares) is work of an algorithm, not of the function. The count must be
// exact on any `cum`, NaN and +-inf included, because the card's parallel
// `torch.cumsum` is not nondecreasing to the last ulp: a binary search is
// wrong on it.
//
// Design: count only where the count is in doubt.
// 1. `per_sample_summary_kernel` cuts `cum` into tiles of kTile elements and
//    writes, per tile, the minimum and maximum of its non-NaN elements and
//    their number (one warp per tile, 16-byte loads). A NaN counts below no
//    draw, so it is left out of all three; elements past `n` do not exist.
// 2. `per_sample_count_kernel` gives each draw v one warp, whose lanes walk
//    the tile summaries. A tile whose maximum is below v adds its count
//    (every non-NaN element is below v); a tile whose minimum is not below v
//    adds nothing (no element is; this also covers a NaN draw); every other
//    tile goes into a queue in shared memory, which all the block's warps
//    (kDraws draws a block) then count element by element, two tiles a warp
//    with both tiles' 16-byte loads in flight. The integer counts
//    are summed (`__reduce_add_sync`, shared-memory integer adds) and
//    written once: no global atomics, so the output needs no zeroing launch.
// On a nearly sorted cumsum one or two tiles straddle most draws, so a draw
// costs ~n / kTile summary reads plus a tile or two, instead of n compares.
// A draw on a run of equal values (empty ring slots) that the card's scan
// leaves off by an ulp here and there straddles many tiles; the slowest
// draw bounds the kernel, so the block's warps share its tiles. On an
// unsorted cumsum every tile straddles and the kernel counts everything,
// still exactly. The second launch uses programmatic dependent launch
// (Hopper): it may be scheduled while the first runs and waits for its
// results with `griddepcontrol.wait`; on an H100 that timed faster than two
// plain launches and than one cooperative launch with a grid barrier.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // cum elements per tile summary
constexpr int kWarps = 8;    // warps per block of the summary kernel
constexpr int kDraws = 16;   // draws (one warp each) per block of the count kernel
constexpr int kBatch = 8;    // tile summaries a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) Summary {
  float lo;   // minimum of the tile's non-NaN elements (+inf if none)
  float hi;   // maximum of the tile's non-NaN elements (-inf if none)
  int count;  // number of the tile's non-NaN elements
  int pad;
};

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void per_sample_summary_kernel(const float* __restrict__ cum,
                                          Summary* __restrict__ sums, int n, int tiles) {
  // The count kernel may be scheduled now; it waits for this grid's results.
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;  // whole warps
  const int base = t * kTile;  // below n < 2^31
  const int len = min(kTile, n - base);
  float lo = __int_as_float(0x7f800000);   // +inf
  float hi = __int_as_float(0xff800000);   // -inf
  int count = 0;
  auto take = [&](float x) {
    if (x == x) {
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
      ++count;
    }
  };
  if (len == kTile && aligned16(cum)) {
    const float4* p = reinterpret_cast<const float4*>(cum + base);
#pragma unroll
    for (int k = 0; k < kTile / 128; ++k) {
      const float4 x = __ldg(p + k * 32 + lane);
      take(x.x);
      take(x.y);
      take(x.z);
      take(x.w);
    }
  } else {
    for (int i = lane; i < len; i += 32) take(__ldg(cum + base + i));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) sums[t] = Summary{lo, hi, count, 0};
}

// This lane's share of #{i in tile t : cum[i] < v}.
__device__ __forceinline__ int count_tile(const float* __restrict__ cum, int t, int n, float v,
                                          int lane, bool vec) {
  const int base = t * kTile;  // below n < 2^31
  const int len = min(kTile, n - base);
  int c = 0;
  if (vec && len == kTile) {
    const float4* p = reinterpret_cast<const float4*>(cum + base);
#pragma unroll
    for (int k = 0; k < kTile / 128; ++k) {
      const float4 x = __ldg(p + k * 32 + lane);
      c += (x.x < v) + (x.y < v) + (x.z < v) + (x.w < v);
    }
  } else {
    for (int i = lane; i < len; i += 32) c += __ldg(cum + base + i) < v;
  }
  return c;
}

// This lane's shares of the counts below va in tile ta and below vb in tile
// tb (-1: none), both tiles' loads issued before any compare when both are
// full and aligned.
__device__ __forceinline__ void count_pair(const float* __restrict__ cum, int ta, float va,
                                           int tb, float vb, int n, int lane, bool vec,
                                           int* ca, int* cb) {
  if (tb >= 0 && vec && n - ta * kTile >= kTile && n - tb * kTile >= kTile) {
    const float4* pa = reinterpret_cast<const float4*>(cum + ta * kTile);
    const float4* pb = reinterpret_cast<const float4*>(cum + tb * kTile);
    float4 xa[kTile / 128];
    float4 xb[kTile / 128];
#pragma unroll
    for (int k = 0; k < kTile / 128; ++k) {
      xa[k] = __ldg(pa + k * 32 + lane);
      xb[k] = __ldg(pb + k * 32 + lane);
    }
    int a = 0;
    int b = 0;
#pragma unroll
    for (int k = 0; k < kTile / 128; ++k) {
      a += (xa[k].x < va) + (xa[k].y < va) + (xa[k].z < va) + (xa[k].w < va);
      b += (xb[k].x < vb) + (xb[k].y < vb) + (xb[k].z < vb) + (xb[k].w < vb);
    }
    *ca = a;
    *cb = b;
    return;
  }
  *ca = count_tile(cum, ta, n, va, lane, vec);
  *cb = tb >= 0 ? count_tile(cum, tb, n, vb, lane, vec) : 0;
}

__global__ void per_sample_count_kernel(const float* __restrict__ cum,
                                        const Summary* __restrict__ sums,
                                        const float* __restrict__ u, int* __restrict__ out,
                                        int n, int tiles, int q) {
  __shared__ float s_v[kDraws];                   // the block's draws
  __shared__ int s_count[kDraws];                 // their counts from straddled tiles
  __shared__ int s_queue[kDraws * 32 * kBatch];   // straddled tiles: tile << 4 | draw
  __shared__ int s_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kDraws + warp;
  const bool live = qi < q;
  const float v = live ? __ldg(u + qi) : 0.0f;
  if (lane == 0) {
    s_v[warp] = v;
    s_count[warp] = 0;
  }
  if (threadIdx.x == 0) s_len = 0;
  const bool vec = aligned16(cum);
  // The summaries are the previous grid's: wait until they are complete
  // and visible (a no-op when nothing precedes this grid).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();
  // Each warp settles its draw's tiles from their summaries, 32 * kBatch at
  // once (one latency; a missing tile reads as an empty one, which settles
  // as nothing), and queues the tiles it cannot settle; then the block's
  // warps count the queued tiles round-robin, whichever draw they belong
  // to, so one draw's many straddled tiles do not hold the block up.
  const Summary empty{__int_as_float(0x7f800000), __int_as_float(0xff800000), 0, 0};
  int count = 0;
  for (int c0 = 0; c0 < tiles; c0 += 32 * kBatch) {
    Summary s[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int t = c0 + r * 32 + lane;
      s[r] = live && t < tiles ? sums[t] : empty;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      bool straddles = false;
      if (s[r].hi < v) {
        count += s[r].count;
      } else {
        straddles = s[r].lo < v;
      }
      const unsigned todo = __ballot_sync(kFull, straddles);
      if (todo) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_len, __popc(todo));
        at = __shfl_sync(kFull, at, 0);
        if (straddles) {
          s_queue[at + __popc(todo & ((1u << lane) - 1))] = (c0 + r * 32 + lane) << 4 | warp;
        }
      }
    }
    __syncthreads();
    // Two queued tiles a warp at a time, both tiles' loads in flight.
    const int len = s_len;
    for (int i = warp; i < len; i += 2 * kDraws) {
      const int a = s_queue[i];
      const int b = i + kDraws < len ? s_queue[i + kDraws] : -1;
      int ca, cb;
      count_pair(cum, a >> 4, s_v[a & 15], b < 0 ? -1 : b >> 4, s_v[b < 0 ? 0 : b & 15], n, lane,
                 vec, &ca, &cb);
      ca = __reduce_add_sync(kFull, ca);
      cb = __reduce_add_sync(kFull, cb);
      if (lane == 0) {
        atomicAdd(&s_count[a & 15], ca);
        if (b >= 0) atomicAdd(&s_count[b & 15], cb);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) s_len = 0;
    __syncthreads();
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0 && live) out[qi] = count + s_count[warp];
}

}  // namespace

// `sums` is scratch of ceil(n / kTile) 16-byte summaries.
extern "C" int count_below_launch(const float* cum, const float* u, int* out, void* sums, int n,
                                  int q, void* stream) {
  if (q == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = n / kTile + (n % kTile != 0);
  Summary* summaries = static_cast<Summary*>(sums);
  if (tiles > 0) {
    per_sample_summary_kernel<<<(tiles + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
        cum, summaries, n, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((q + kDraws - 1) / kDraws);
  cfg.blockDim = dim3(kDraws * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Summary* ro = summaries;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, per_sample_count_kernel, cum, ro, u, out, n, tiles, q));
}

extern "C" const char* per_sample_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
