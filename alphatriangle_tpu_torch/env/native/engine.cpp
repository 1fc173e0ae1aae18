// Native host-side triangle-puzzle engine (batched bitboard core): the
// port's copy of the JAX package's engine.cpp.
//
// Role: a host engine for host-side consumers (interactive play,
// debugging, tests) where a tensor engine's per-move dispatch costs more
// than the move. The device path stays the PyTorch engine
// (env/engine.py); both play on the same precomputed bitboard tables,
// built once in Python (engine._build_bit_tables) and passed in at
// create time, so the transition rules are one by construction (pinned
// by tests/test_torch_play.py against the PyTorch engine).
//
// ABI: plain C over caller-owned NumPy buffers (struct of arrays), bound
// with ctypes; built with g++ at first use into the package's _build/.
//
// Board encoding: the (R, C) occupancy grid packs into NW = ceil(R*C/32)
// uint32 words. Placement legality for (shape s, origin o) is
// `footprint[s][o] & occ_ext == 0` where occ_ext appends one extra
// always-0xFFFFFFFF word and impossible placements store a sentinel bit
// in that word. Line clears are word masks + popcount.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Engine {
  int rows, cols, slots, n_shapes, nw, n_lines, n_colors;
  int cells, action_dim;
  float reward_placed, reward_cleared, penalty_game_over;
  // footprint_ext: n_shapes * cells * (nw + 1) words.
  std::vector<uint32_t> fp;
  // line_words: n_lines * nw words.
  std::vector<uint32_t> lines;

  const uint32_t* fp_row(int shape, int origin) const {
    return fp.data() + (static_cast<size_t>(shape) * cells + origin) * (nw + 1);
  }
};

inline bool fits(const Engine& e, const uint32_t* occ, int shape, int origin) {
  const uint32_t* row = e.fp_row(shape, origin);
  uint32_t collide = row[e.nw];  // sentinel word vs implicit all-ones
  for (int w = 0; w < e.nw; ++w) collide |= row[w] & occ[w];
  return collide == 0;
}

inline bool any_placement(const Engine& e, const uint32_t* occ,
                          const int32_t* hand) {
  for (int s = 0; s < e.slots; ++s) {
    if (hand[s] < 0) continue;
    for (int o = 0; o < e.cells; ++o)
      if (fits(e, occ, hand[s], o)) return true;
  }
  return false;
}

// xorshift64* — deterministic host PRNG for hand refills. (The tensor
// engines draw refills from their threefry keys; native trajectories are
// therefore equally distributed but not bit-identical to theirs once a
// refill happens — the parity tests pin the refill-free transition,
// which is everything except the draw.)
inline uint64_t next_rng(uint64_t& s) {
  s ^= s >> 12;
  s ^= s << 25;
  s ^= s >> 27;
  return s * 0x2545F4914F6CDD1DULL;
}

}  // namespace

extern "C" {

void* at_create(int rows, int cols, int slots, int n_shapes, int nw,
                int n_lines, int n_colors, float reward_placed,
                float reward_cleared, float penalty_game_over,
                const uint32_t* fp, const uint32_t* lines) {
  Engine* e = new Engine();
  e->rows = rows;
  e->cols = cols;
  e->slots = slots;
  e->n_shapes = n_shapes;
  e->nw = nw;
  e->n_lines = n_lines;
  e->n_colors = n_colors;
  e->cells = rows * cols;
  e->action_dim = slots * e->cells;
  e->reward_placed = reward_placed;
  e->reward_cleared = reward_cleared;
  e->penalty_game_over = penalty_game_over;
  e->fp.assign(fp, fp + static_cast<size_t>(n_shapes) * e->cells * (nw + 1));
  e->lines.assign(lines, lines + static_cast<size_t>(n_lines) * nw);
  return e;
}

void at_destroy(void* ptr) { delete static_cast<Engine*>(ptr); }

// Valid-action masks for n games: out[n * action_dim], 1 = legal.
// All-zero rows for finished games (mirrors valid_action_mask).
void at_valid_mask(const void* ptr, int n, const uint32_t* occ,
                   const int32_t* hand, const uint8_t* done, uint8_t* out) {
  const Engine& e = *static_cast<const Engine*>(ptr);
  for (int g = 0; g < n; ++g) {
    const uint32_t* gocc = occ + static_cast<size_t>(g) * e.nw;
    const int32_t* ghand = hand + static_cast<size_t>(g) * e.slots;
    uint8_t* gout = out + static_cast<size_t>(g) * e.action_dim;
    if (done[g]) {
      std::memset(gout, 0, e.action_dim);
      continue;
    }
    for (int s = 0; s < e.slots; ++s) {
      const bool held = ghand[s] >= 0;
      for (int o = 0; o < e.cells; ++o)
        gout[s * e.cells + o] =
            held && fits(e, gocc, ghand[s], o) ? 1 : 0;
    }
  }
}

// One transition for each of n games (in-place SoA updates). Mirrors
// env/engine.py `step`: placement -> simultaneous full-line clear ->
// slot consume (+ refill when the hand empties and `refill` != 0) ->
// stuck/forfeit termination. Finished games are strict no-ops.
void at_step(const void* ptr, int n, int refill, uint32_t* occ, int8_t* color,
             int32_t* hand, int8_t* hand_color, const int32_t* actions,
             uint64_t* rng, float* rewards, uint8_t* done, float* score,
             int32_t* step_count, int32_t* last_cleared) {
  const Engine& e = *static_cast<const Engine*>(ptr);
  std::vector<uint32_t> cleared(e.nw);
  for (int g = 0; g < n; ++g) {
    uint32_t* gocc = occ + static_cast<size_t>(g) * e.nw;
    int8_t* gcolor = color + static_cast<size_t>(g) * e.cells;
    int32_t* ghand = hand + static_cast<size_t>(g) * e.slots;
    int8_t* ghand_color = hand_color + static_cast<size_t>(g) * e.slots;

    if (done[g]) {  // finished games freeze (lockstep no-op)
      rewards[g] = 0.0f;
      continue;
    }
    const int action = actions[g];
    const int slot = action / e.cells;
    const int origin = action % e.cells;
    const bool in_range = action >= 0 && action < e.action_dim;
    const bool valid =
        in_range && ghand[slot] >= 0 && fits(e, gocc, ghand[slot], origin);
    if (!valid) {  // forfeit: state frozen, game over
      rewards[g] = e.penalty_game_over;
      done[g] = 1;
      last_cleared[g] = 0;
      continue;
    }
    const int shape = ghand[slot];
    const uint32_t* row = e.fp_row(shape, origin);

    // Place: board bits + color plane + triangle count.
    int n_placed = 0;
    for (int w = 0; w < e.nw; ++w) {
      uint32_t bits = row[w];
      gocc[w] |= bits;
      while (bits) {
        const int b = __builtin_ctz(bits);
        bits &= bits - 1;
        gcolor[w * 32 + b] = ghand_color[slot];
        ++n_placed;
      }
    }

    // Clear every simultaneously-full line.
    std::memset(cleared.data(), 0, e.nw * sizeof(uint32_t));
    for (int l = 0; l < e.n_lines; ++l) {
      const uint32_t* line = e.lines.data() + static_cast<size_t>(l) * e.nw;
      bool full = true;
      for (int w = 0; w < e.nw && full; ++w)
        full = (gocc[w] & line[w]) == line[w];
      if (full)
        for (int w = 0; w < e.nw; ++w) cleared[w] |= line[w];
    }
    int n_cleared = 0;
    for (int w = 0; w < e.nw; ++w) {
      n_cleared += __builtin_popcount(cleared[w]);
      gocc[w] &= ~cleared[w];
      uint32_t bits = cleared[w];
      while (bits) {
        const int b = __builtin_ctz(bits);
        bits &= bits - 1;
        gcolor[w * 32 + b] = -1;
      }
    }

    // Consume the slot; refill when the whole hand is empty.
    ghand[slot] = -1;
    bool all_empty = true;
    for (int s = 0; s < e.slots; ++s) all_empty = all_empty && ghand[s] < 0;
    if (all_empty && refill) {
      for (int s = 0; s < e.slots; ++s) {
        ghand[s] = static_cast<int32_t>(next_rng(rng[g]) % e.n_shapes);
        ghand_color[s] =
            static_cast<int8_t>(next_rng(rng[g]) % e.n_colors);
      }
    }

    const float gain = static_cast<float>(n_placed) * e.reward_placed +
                       static_cast<float>(n_cleared) * e.reward_cleared;
    const bool stuck = !any_placement(e, gocc, ghand);
    rewards[g] = gain + (stuck ? e.penalty_game_over : 0.0f);
    score[g] += gain;
    step_count[g] += 1;
    last_cleared[g] = n_cleared;
    done[g] = stuck ? 1 : 0;
  }
}

}  // extern "C"
