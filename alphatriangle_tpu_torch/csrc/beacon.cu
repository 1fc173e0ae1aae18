// Progress-beacon writer: one stream-ordered row of (seq, phase, index,
// program) into a ring in mapped pinned host memory.
//
// Replaces no TPU kernel. The JAX package marks phase boundaries with
// `jax.debug.callback` (`alphatriangle_tpu/telemetry/device_stats.py::
// emit_beacon`), which the TPU runtime fires when the device reaches it.
// The port enqueues a whole dispatch before the host blocks in its fetch,
// so a row written by the host at enqueue time would name the last phase
// enqueued, not the one the card has reached; this kernel takes the
// callback's place in stream order.
//
// Bound on Hopper: neither bytes nor operations. It moves 32 bytes over
// PCIe and does one atomic; its time is the launch. Design: one thread.
// The slot comes from a system-scope atomicAdd on a counter in device
// memory (the overlapped loop's producer streams emit concurrently), the
// three id words are stored, `__threadfence_system()` orders them before
// the slot's sequence number, which is stored last through a volatile
// pointer. The host drainer reads the sequence number, the words, then
// the sequence number again, and takes the row only when both reads
// equal the number it expects; a slot the ring wrapped over is counted
// as dropped.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void beacon_kernel(unsigned long long* counter, long long* ring, int slots,
                              long long phase, long long index, long long program) {
  const unsigned long long n = atomicAdd_system(counter, 1ULL);
  volatile long long* slot = ring + (n % static_cast<unsigned long long>(slots)) * 4;
  slot[1] = phase;
  slot[2] = index;
  slot[3] = program;
  __threadfence_system();
  slot[0] = static_cast<long long>(n + 1);
}

}  // namespace

extern "C" int beacon_launch(void* counter, void* ring, int slots, long long phase,
                             long long index, long long program, void* stream) {
  beacon_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counter), static_cast<long long*>(ring), slots, phase,
      index, program);
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory; fails unless it is mapped.
extern "C" int beacon_device_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

extern "C" const char* beacon_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
