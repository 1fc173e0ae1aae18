// Fused MCTS edge-plane update, in place: W child insertions, then the W x D
// visit/return backup adds along the recorded descent paths.
//
// Replaces the TPU kernel `alphatriangle_tpu/ops/mcts_backup.py::_backup_kernel`
// (launched by `backup_update_pallas`), which held a game's four (N, A) planes
// in VMEM and applied every update as a one-hot row read-modify-write. Four
// flagship planes are ~374 KB per game, more than an SM's shared memory, so
// this kernel leaves the planes in device memory and touches only the
// W * (D + 1) addressed elements, one block per game.
//
// Semantics (bit parity with the XLA scatter chain, `backup_update_xla`, and
// the port's plain version):
// - children[p, a] = maximum of the old value and every member's new_child on
//   that edge, folded in member order as torch.maximum folds it (NaN wins).
// - e_reward[p, a] = rewards[j] of the LAST member j with that edge.
// - Each entry e = level * W + member targets (max(node, 0), max(action, 0))
//   and adds 1.0 / its return when active, +0.0 / +0.0 when not, in e order.
//   Float sums keep that order, so no float atomics.
//
// Bound on Hopper: the bytes are a few KB per game (0.13 us at B = 64), far
// below a launch, so the block's critical path bounds it: two dependent
// loads (the entries, then the plane values they address), grouping the
// entries by element, and one ordered fold per element. Past one block per
// SM (B > 132 on an H100) the blocks sharing an SM also share its
// instruction issue, and the time grows with B (`chip_smoke.py` times it
// against B). Finding each
// element's entries by scanning the others is O(E^2) per block (E = W * D =
// 256) and long in a real wave, where every inactive entry maps to (0, 0); a
// bitonic sort is O(E log^2 E) but 36 dependent steps at E = 256. Design:
// - Staging. The entries are loaded in memory order (member-major, so the
//   loads coalesce) and staged in shared memory in e order; the plane values
//   they address are loaded at once but stored only after the grouping, whose
//   barriers hide their latency.
// - Grouping in two barriers. Each warp holds 32 consecutive entries (a
//   chunk); `__match_any_sync` on the element key gives the chunk's lanes of
//   each element. The lowest of them inserts the key into a hash table in
//   shared memory with `atomicCAS` (at most one insertion per chunk and key);
//   the one that creates the slot takes the next dense group id. Then each
//   chunk's lowest lane writes its lanes of the group into the group's chunk
//   mask, active entries only. Group ids follow the order of `atomicAdd`,
//   which varies, but nothing depends on them: each group writes only its own
//   element, and each list below is in e order.
// - Compaction. Thread g counts group g's active entries chunk by chunk; a
//   warp of such threads takes one range of a shared list (one `atomicAdd`)
//   and splits it by a shuffle scan; each active entry writes its return at
//   its rank in e order within its group's range.
// - The fold. Thread g folds group g's range in order, several entries a
//   read, in registers from the plane values; then one write per plane.
// - Inactive entries add +0.0, and one +0.0 per element stands for them all:
//   * x + (+0.0) == x for every float x except -0.0 (and a NaN, which an add
//     makes canonical), under round-to-nearest.
//   * A sum is -0.0 only if both addends are -0.0.
//   So in the sequence v0, a_1, ..., the +0.0 of an inactive entry changes the
//   running sum only while it is still -0.0 (v0 and every active addend so far
//   -0.0), and then makes it +0.0. Folding the active entries first and adding
//   +0.0 once at the end, if the element has an inactive entry, gives the same
//   bits: if the active fold ends in a value other than -0.0 the +0.0 leaves it
//   alone, and the ordered fold reaches the same value (its +0.0 either
//   changed nothing or turned a leading -0.0 into +0.0, which the next
//   addend that is not -0.0 absorbs: +-0.0 + y == y); if the active fold ends
//   in -0.0, every addend was -0.0 and the ordered fold ends in +0.0, which is
//   what the final +0.0 gives. A fold's length is then its element's active
//   entries, not the wave's inactive ones. `tests/test_torch_kernels.py` holds
//   this on planes of -0.0.
// - Insertion. For W <= 32 an extra warp holds one member a lane and runs
//   beside the backup from the start (the backup's barriers are named and
//   leave it out): `__match_any_sync` gives each lane the members on its
//   edge; the lowest folds the maximum in member order and the highest writes
//   the reward. Otherwise (W > 32, or a block already of 1024 threads) the
//   members go through the same grouping after the backup.
// No O(E^2) or O(W^2) scan remains.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 1024;  // W * D (and W) per game: one entry per thread
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0xffffffffu;  // no key (keys are below 2^31)
constexpr int kUnroll = 4;                // entries a fold reads at once

// Bytes of the grouping's tables for p grouping threads (a power of two, at
// least 32): a hash table of 2p slots (key, group); per group its key, p / 32
// chunk masks, whether an entry was left out of the fold, its payload, its
// list range (start, length); the list; two counters.
__host__ __device__ constexpr size_t group_bytes(int p) {
  return static_cast<size_t>(p) * (8 + 8 + 4 + p / 8 + 4 + 4 + 4 + 4 + 4) + 16;
}

struct Groups {
  unsigned* slot_key;  // (2p,)
  int* slot_group;     // (2p,)
  unsigned* key;       // (p,)
  unsigned* mask;      // (p / 32, p): mask[c * p + group]
  int* unfolded;       // (p,)
  int* payload;        // (p,) the creating item's payload
  int* start;          // (p,) the group's range of `list`
  int* length;         // (p,)
  float* list;         // (p,)
  int* count;          // groups
  int* used;           // entries of `list` handed out

  __device__ Groups(unsigned char* smem, int p) {
    slot_key = reinterpret_cast<unsigned*>(smem);
    slot_group = reinterpret_cast<int*>(slot_key + 2 * p);
    key = reinterpret_cast<unsigned*>(slot_group + 2 * p);
    mask = key + p;
    unfolded = reinterpret_cast<int*>(mask + p / 32 * p);
    payload = unfolded + p;
    start = payload + p;
    length = start + p;
    list = reinterpret_cast<float*>(length + p);
    count = reinterpret_cast<int*>(list + p);
    used = count + 1;
  }
};

// The barrier of the p grouping threads (an insertion warp beyond them never
// waits on it).
__device__ __forceinline__ void sync_group(int p) {
  asm volatile("bar.sync 1, %0;" ::"r"(p) : "memory");
}

// Empties the grouping's tables; a barrier must follow before `group_items`.
__device__ __forceinline__ void reset_groups(const Groups& g, int p) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * p; i += p) g.slot_key[i] = kEmpty;
  for (int c = 0; c < p / 32; ++c) g.mask[c * p + tid] = 0;
  g.unfolded[tid] = 0;
  if (tid == 0) *g.count = *g.used = 0;
}

// Groups items 0..p-1 (item i in thread i; those with `valid` unset take no
// part) by `key`, in tables emptied by `reset_groups`; the item that creates
// a group stores `payload` (all items of a group must pass the same). After
// it: *g.count groups; g.mask[c * p + group] holds the lanes of chunk c
// (items 32c..32c+31) in the group that have `fold` set, 0 where it has none;
// g.unfolded[group] is 1 if one of its items has `fold` unset. Returns
// the item's group (-1 if not valid); `*mine` is its chunk's lanes of the
// group that have `fold` set. Every grouping thread calls it.
__device__ int group_items(const Groups& g, int p, bool valid, unsigned key, bool fold,
                           int payload, unsigned* mine) {
  const int tid = threadIdx.x;
  const unsigned peers = __match_any_sync(kFull, valid ? key : kEmpty);
  const unsigned folded = __ballot_sync(kFull, valid && fold);
  const int leader = __ffs(peers) - 1;
  const bool leads = valid && (tid & 31) == leader;
  const int bits = 32 - __clz(2 * p - 1);  // log2(2p)
  unsigned slot = (key * 2654435761u) >> (32 - bits);
  if (leads) {
    for (;;) {
      const unsigned prev = atomicCAS(g.slot_key + slot, kEmpty, key);
      if (prev == kEmpty) {
        const int group = atomicAdd(g.count, 1);
        g.slot_group[slot] = group;
        g.key[group] = key;
        g.payload[group] = payload;
        break;
      }
      if (prev == key) break;
      slot = (slot + 1) & (2 * p - 1);
    }
  }
  sync_group(p);
  int group = -1;
  if (leads) {
    group = g.slot_group[slot];
    g.mask[(tid >> 5) * p + group] = peers & folded;
    if (peers & ~folded) g.unfolded[group] = 1;
  }
  group = __shfl_sync(kFull, group, leader);
  *mine = peers & folded;
  sync_group(p);
  return group;
}

// n / d, exactly for n * d < 2^32, from m = ceil(2^32 / d) (a multiply, not a
// division; m is unused for d = 1).
__device__ __forceinline__ int quot(int n, int d, unsigned m) {
  return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
}

// torch.maximum(m, x): NaN if either is NaN, else the larger.
__device__ __forceinline__ float maximum(float m, float x) {
  return m != m ? m : (x != x ? x : fmaxf(m, x));
}

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
                                     int d, int p, unsigned w_magic, unsigned d_magic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const Groups g(smem, p);
  float* s_nc = reinterpret_cast<float*>(smem + group_bytes(p));  // (p,) member j's new_child
  // The entries staged in e order, padded: entry (lvl, j) at j * (d + 1) + lvl.
  unsigned* s_key = reinterpret_cast<unsigned*>(s_nc + p);  // element key, bit 31: inactive
  float* s_ret = reinterpret_cast<float*>(s_key + w * (d + 1));
  float* s_v0 = s_ret + w * (d + 1);  // visits at the entry's element, before the update
  float* s_q0 = s_v0 + w * (d + 1);   // value at the entry's element, before the update

  // This game's operands.
  const int entries = w * d;
  const int64_t b = blockIdx.x;
  const int64_t plane = b * n * a;
  visits += plane;
  value += plane;
  children += plane;
  reward += plane;
  parents += b * w;
  actions += b * w;
  new_child += b * w;
  rewards += b * w;
  rec_node += b * entries;
  rec_action += b * entries;
  rec_active += b * entries;
  returns += b * entries;

  // The members: for W <= 32 the insertion warp past the p grouping threads
  // (when the block has room for it) holds them (lane j) and inserts, alone;
  // else member tid, inserted after the backup.
  const bool insertion_warp = static_cast<int>(blockDim.x) > p;
  const int j = insertion_warp ? tid - p : tid;
  unsigned ins_key = 0;
  if (j >= 0 && j < w) {
    const int64_t pa = parents[j];
    const int64_t ac = actions[j];
    assert(pa >= 0 && pa < n && ac >= 0 && ac < a);
    ins_key = static_cast<unsigned>(pa * a + ac);
    s_nc[j] = new_child[j];
  }
  if (tid >= p) {
    // Insertion for W <= 32: children max (the edge's first member), reward
    // set (its last).
    __syncwarp();
    if (j < w) {
      const unsigned members = w == 32 ? kFull : (1u << w) - 1;
      const unsigned peers = __match_any_sync(members, ins_key);
      if (j == __ffs(peers) - 1) {
        float m = children[ins_key];
        for (unsigned rest = peers; rest; rest &= rest - 1) m = maximum(m, s_nc[__ffs(rest) - 1]);
        children[ins_key] = m;
      }
      if (j == 31 - __clz(peers)) reward[ins_key] = rewards[j];
    }
    return;
  }

  // Staging: entry t in memory order (coalesced loads), and the plane values
  // it addresses, which stay in registers until the grouping is done.
  // Entry t = j * d + lvl sits at j * (d + 1) + lvl = t + j.
  const int staged_at = tid < entries ? tid + quot(tid, d, d_magic) : 0;
  float v0 = 0.0f;
  float q0 = 0.0f;
  if (tid < entries) {
    const int64_t nd = rec_node[tid] > 0 ? rec_node[tid] : 0;
    const int64_t ac = rec_action[tid] > 0 ? rec_action[tid] : 0;
    assert(nd < n && ac < a);
    const unsigned key = static_cast<unsigned>(nd * a + ac);
    v0 = visits[key];
    q0 = value[key];
    s_key[staged_at] = key | static_cast<unsigned>(rec_active[tid] == 0) << 31;
    s_ret[staged_at] = returns[tid];
  }
  reset_groups(g, p);
  sync_group(p);

  // Entry tid in e order: level tid / w, member tid % w.
  const int lvl = quot(tid, w, w_magic);
  const int at = tid < entries ? (tid - lvl * w) * (d + 1) + lvl : 0;
  const unsigned staged = tid < entries ? s_key[at] : 0;
  const bool active = tid < entries && !(staged >> 31);
  const float ret = tid < entries ? s_ret[at] : 0.0f;
  unsigned mine;
  const int group =
      group_items(g, p, tid < entries, staged & 0x7fffffffu, active, at, &mine);
  if (tid < entries) {
    s_v0[staged_at] = v0;
    s_q0[staged_at] = q0;
  }

  // Compaction: thread `tid` counts group `tid`'s active entries chunk by
  // chunk (eight masks read at once; they become the chunks' offsets), and
  // each warp of such threads takes one range of the list for its groups.
  const int groups = *g.count;
  if ((tid & ~31) < groups) {
    int run = 0;
    if (tid < groups) {
      for (int c0 = 0; c0 < p / 32; c0 += 8) {
        unsigned mk[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) mk[r] = c0 + r < p / 32 ? g.mask[(c0 + r) * p + tid] : 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (mk[r]) g.mask[(c0 + r) * p + tid] = run;
          run += __popc(mk[r]);
        }
      }
    }
    int upto = run;  // inclusive prefix over the warp's lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, o);
      if ((tid & 31) >= o) upto += y;
    }
    int base = 0;
    if ((tid & 31) == 31) base = atomicAdd(g.used, upto);
    base = __shfl_sync(kFull, base, 31);
    if (tid < groups) {
      g.start[tid] = base + upto - run;
      g.length[tid] = run;
    }
  }
  sync_group(p);
  if (active) {
    const unsigned below = mine & ((1u << (tid & 31)) - 1);
    g.list[g.start[group] + g.mask[(tid >> 5) * p + group] + __popc(below)] = ret;
  }
  sync_group(p);

  // Backup: thread `tid` folds group `tid`'s active entries in e order,
  // kUnroll list reads at a time.
  if (tid < groups) {
    float v = s_v0[g.payload[tid]];
    float q = s_q0[g.payload[tid]];
    const int start = g.start[tid];
    const int length = g.length[tid];
    for (int k = 0; k < length; k += kUnroll) {
      float r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = k + u < length ? g.list[start + k + u] : 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < length) {
          v = __fadd_rn(v, 1.0f);
          q = __fadd_rn(q, r[u]);
        }
      }
    }
    if (g.unfolded[tid]) {
      // The element's inactive entries: one +0.0 stands for all (see above).
      v = __fadd_rn(v, 0.0f);
      q = __fadd_rn(q, 0.0f);
    }
    visits[g.key[tid]] = v;
    value[g.key[tid]] = q;
  }
  if (insertion_warp) return;

  // Insertion without the warp, through the same grouping.
  sync_group(p);  // the tables are reused
  reset_groups(g, p);
  sync_group(p);
  group_items(g, p, tid < w, ins_key, true, 0, &mine);
  if (tid < *g.count) {
    float m = children[g.key[tid]];
    int last = 0;
    for (int c = 0; c < p / 32; ++c) {
      for (unsigned rest = g.mask[c * p + tid]; rest; rest &= rest - 1) {
        last = c * 32 + __ffs(rest) - 1;
        m = maximum(m, s_nc[last]);
      }
    }
    children[g.key[tid]] = m;
    reward[g.key[tid]] = rewards[last];
  }
}

}  // namespace

extern "C" int backup_update_launch(float* visits, float* value, float* children, float* reward,
                                    const int64_t* parents, const int64_t* actions,
                                    const float* new_child, const float* rewards,
                                    const int64_t* rec_node, const int64_t* rec_action,
                                    const uint8_t* rec_active, const float* returns, int b,
                                    int n, int a, int w, int d, void* stream) {
  if (b == 0 || w == 0) return 0;
  const int entries = w * d > w ? w * d : w;  // the backup's entries, or the members
  if (entries > kMaxEntries) return static_cast<int>(cudaErrorInvalidValue);
  int p = 32;  // grouping threads
  while (p < entries) p <<= 1;
  const int threads = w <= 32 && p < kMaxEntries ? p + 32 : p;  // and the insertion warp
  // The grouping's tables, the members' new_child, then four staged values
  // per entry (padded to W * (D + 1)).
  const size_t shared = group_bytes(p) + static_cast<size_t>(p) * 4 +
                        4 * static_cast<size_t>(w) * (d + 1) * 4;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        backup_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // ceil(2^32 / x) for the kernel's divisions by W and D (unused for 1).
  const auto magic = [](int x) { return x > 1 ? 0xffffffffu / x + 1 : 0u; };
  backup_update_kernel<<<b, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      visits, value, children, reward, parents, actions, new_child, rewards, rec_node,
      rec_action, rec_active, returns, n, a, w, d, p, magic(w), magic(d));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* backup_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
