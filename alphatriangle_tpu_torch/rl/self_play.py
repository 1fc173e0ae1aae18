"""Batched self-play: counterpart of `alphatriangle_tpu/rl/self_play.py`
(`RolloutCarry`, `SelfPlayEngine`): PUCT or Gumbel root search, with
playout-cap randomization or subtree reuse.

One engine steps B games in lockstep on one device. A rollout chunk is
`num_moves` moves of: features of every game, one batched
`BatchedMCTS.search`, the policy target from the root visits, the
maturing of the n-step window slot added n moves ago (bootstrapped with
this search's root value), a temperature-scheduled action draw, one
batched env step, the reward folded into every pending slot, the
trailing flush of the windows of games that ended (or hit
`MAX_EPISODE_MOVES`), and in-place resets of the finished games. Each
move emits fixed-shape (B,) and (B, n) blocks with boolean masks and a
small per-move `trace`; the chunk stacks them over its moves.

The key schedule is the JAX engine's: `split(carry.rng, 5)` per move
into (rng, search, select, reset, mode) keys, all single keys on the
CPU, so the search and the draws replay the JAX package's streams.

Under `root_selection="gumbel"` the search is `GumbelMCTS`: the move
plays its `selected_action` and its policy target is the completed-Q
`improved_policy`. Playout-cap randomization (`fast_simulations`,
KataGo arXiv:1902.10565 §3.1) draws once per move, on the host from the
mode key, whether all lanes run the full search (probability
`full_search_prob`) or a second engine of `fast_simulations` with no
root noise (Gumbel: `exploit=True`; PUCT: temperature 0). A fast move's
rows carry policy weight 0 and, unless `pcr_record_fast_rows`, never
mature or flush into the ring. The trace's `sims` and `is_full` record
each move's choice. With `MCTSConfig.tree_reuse` the
carry holds a `CarriedTree`: each move searches from it and promotes
the played action's subtree for the next move (games that end start
fresh), and the trace's `reused` counts the root visits inherited. The
chunk runs under `torch.no_grad()` with the net in eval mode; it
fetches nothing until the caller asks (`play_chunk` fetches once).

Lane sharding: a dp rank's engine (`lanes`, an `rng.Lanes` of the
global lane array) steps only its rows [lo, hi). Every draw over the
lane dimension (the first hands, the resets, the root noise, the wave
noise, the action draw) is the global array's draw at those rows
(`rng`'s `lanes=`: the rank hashes only its own counters), and every
other key is the unsharded engine's, so each rank's rows equal the
unsharded engine's rows for its lanes bit for bit. A harvest's context
carries each row's move (`row_moves`: its chunk, block and move within
the harvest, in emission order), so the harvests of adjacent lane
shards merge into the rows, in the order, that one engine over their
union emits (`merge_lane_shards`; the training loop's ingest on a mesh
with sp replicas).

Weights: a chunk reads the net's `LiveWeights` once, at its start
(`nn/network.py`), and searches with that module and tags with that
version to its end, whatever a sync installs meanwhile. Each lane's
carry holds the version its current episode started under; a finished
episode reports it (`SelfPlayResult.episode_start_versions`), and a
harvest reports the oldest version any of its chunks played under
(`trainer_step_at_episode_start`), as the JAX engine does. The megastep
passes the learner's module and step instead. A chunk may run on a
stream of its own (a producer thread's): it waits for the weights'
`ready` event and marks their tensors as used on its stream.

Precision: a chunk searches with the weights at
`ModelConfig.INFERENCE_PRECISION` (`_inference_variables`, as the JAX
engine's): the module itself under float32, else the net's one
`InferenceNet` of that weights version (`NeuralNetwork.inference_model`),
cast once on the card and shared by every stream of the loop; a chunk on
another stream waits for the copy's `ready` event. The megastep passes
its own copy, cast from the learner's module once per megastep.

Telemetry: with a run's flight recorder attached (`flight`, by
`training/setup.py` or the loop), each `play_chunk` writes an intent
before its moves are launched and a seal after its one fetch, so the
sealed wall covers the chunk on the card. `dispatch_count` counts the
chunks, `transfer_d2h_seconds` the host seconds blocked in their
fetches, the wait for the card included. Under device stats (the flag
the searches snapshot when built, `device_stats`) each move's stat-pack
joins its outputs as `device_stats`, stacked over the chunk's moves to
(T, SEARCH_PACK_SIZE) and fetched with the rest; `play_chunk` folds it
into `last_device_stats` (`{"search": ..., "rollout": ...}`, the JAX
engine's legs), which the training loop ledgers once per iteration.
"""

import logging
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import rng
from ..config.mcts_config import MCTSConfig
from ..config.train_config import TrainConfig
from ..env.engine import EnvState, TriangleEnv
from ..features.core import FeatureExtractor
from ..mcts.helpers import policy_target_from_visits, select_action_from_visits
from ..mcts.gumbel import GumbelMCTS
from ..mcts.search import BatchedMCTS, CarriedTree
from ..nn.network import LiveWeights
from ..nn.precision import InferenceNet
from ..telemetry.device_stats import (
    fold_search_stats,
    note_dispatch,
    rollout_chunk_stats,
    unpack_search_stats,
)
from ..telemetry.flight import flight_span
from ..telemetry.roofline import chunk_cost, note_program_cost
from ..utils.transfer import fetch, receive
from .types import SelfPlayResult

logger = logging.getLogger(__name__)


@dataclass
class RolloutCarry:
    """Rollout state carried across chunks (on the engine's device,
    apart from the key and the move counter, which live on the host)."""

    env: EnvState  # (B, ...) lockstep game states
    rng: torch.Tensor  # (2,) CPU key
    pend_grid: torch.Tensor  # (B, n, C, H, W) float32 pending features
    pend_other: torch.Tensor  # (B, n, F) float32
    pend_policy: torch.Tensor  # (B, n, A) float32 pending policy targets
    pend_pweight: torch.Tensor  # (B, n) float32 policy-loss weight
    pend_return: torch.Tensor  # (B, n) float32 discounted partial returns
    pend_discount: torch.Tensor  # (B, n) float32 next-reward discounts
    pend_active: torch.Tensor  # (B, n) bool slot occupancy
    episode_start_version: torch.Tensor  # (B,) int32 weights version at episode start
    move_index: int  # global move counter
    tree: "CarriedTree | None" = None  # promoted search tree (tree_reuse)


def _stack(moves: list):
    """Per-move output trees -> one tree stacked over the moves."""
    first = moves[0]
    if isinstance(first, dict):
        return {k: _stack([m[k] for m in moves]) for k in first}
    return torch.stack(moves)


def merge_lane_shards(parts: list, index: int) -> SelfPlayResult:
    """The harvests of adjacent lane shards (in lane order) as one: their
    rows in the order one engine over the shards' union emits them (by
    each row's move, `row_moves`, then by lane), every other field
    shard `index`'s own."""
    if len(parts) == 1:
        return parts[index]
    moves = np.concatenate([p.context["row_moves"] for p in parts])
    order = np.argsort(moves, kind="stable")

    def rows(name: str) -> np.ndarray:
        return np.concatenate([getattr(p, name) for p in parts])[order]

    mine = parts[index]
    return replace(
        mine, grid=rows("grid"), other_features=rows("other_features"),
        policy_target=rows("policy_target"), value_target=rows("value_target"),
        policy_weight=rows("policy_weight"), context={**mine.context, "row_moves": moves[order]},
    )


class SelfPlayEngine:
    """B games played in lockstep, emitting n-step experiences."""

    def __init__(
        self,
        env: TriangleEnv,
        extractor: FeatureExtractor,
        net,
        mcts_config: MCTSConfig,
        train_config: TrainConfig,
        batch_size: "int | None" = None,
        seed: int = 0,
        lanes: "rng.Lanes | None" = None,
    ):
        self.env = env
        self.device = env.device
        self.extractor = extractor
        self.net = net
        self.use_gumbel = mcts_config.root_selection == "gumbel"
        search_cls = GumbelMCTS if self.use_gumbel else BatchedMCTS
        self.mcts = search_cls(env, extractor, net.model, mcts_config, net.support)
        # Playout cap randomization: a second, cheap search for the moves
        # that train no policy, with no root noise.
        self.mcts_fast: "BatchedMCTS | None" = None
        if mcts_config.fast_simulations is not None:
            fast_cfg = mcts_config.model_copy(
                update={
                    "max_simulations": mcts_config.fast_simulations,
                    "fast_simulations": None,
                    "dirichlet_epsilon": 0.0,
                }
            )
            fast_kw = {"exploit": True} if self.use_gumbel else {}
            self.mcts_fast = search_cls(env, extractor, net.model, fast_cfg, net.support, **fast_kw)
        # Fast moves' rows are dropped unless pcr_record_fast_rows.
        self._drop_fast_rows = self.mcts_fast is not None and not mcts_config.pcr_record_fast_rows
        self.config = train_config
        self.mcts_config = mcts_config
        self.batch_size = batch_size or train_config.SELF_PLAY_BATCH_SIZE
        # A dp rank steps its rows [lo, hi) of the global lane array.
        self.lanes = lanes
        if lanes is not None:
            self.batch_size = lanes.hi - lanes.lo
            for search in (self.mcts, self.mcts_fast):
                if search is not None:
                    search.lanes = lanes
        self.n_step = train_config.N_STEP_RETURNS
        self.gamma = train_config.GAMMA

        b, n = self.batch_size, self.n_step
        c = extractor.model_config.GRID_INPUT_CHANNELS
        f = extractor.other_dim
        a = env.action_dim
        self._grid_shape = (c, env.rows, env.cols)
        self._other_dim = f
        self._action_dim = a

        keys = rng.split(rng.PRNGKey(seed))
        dev = self.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._carry = RolloutCarry(
            env=env.reset(rng.split(keys[1], b, lanes=lanes)),
            rng=keys[0],
            pend_grid=zeros(b, n, c, env.rows, env.cols),
            pend_other=zeros(b, n, f),
            pend_policy=zeros(b, n, a),
            pend_pweight=torch.ones((b, n), dtype=torch.float32, device=dev),
            pend_return=zeros(b, n),
            pend_discount=torch.ones((b, n), dtype=torch.float32, device=dev),
            pend_active=zeros(b, n, dtype=torch.bool),
            episode_start_version=torch.full(
                (b,), net.live.version, dtype=torch.int32, device=dev
            ),
            move_index=0,
        )
        if mcts_config.tree_reuse:
            # All-invalid: every lane's first move searches afresh.
            self._carry.tree = self.mcts.zero_carried(self._carry.env)
        # Oldest weights version any chunk of the current harvest window
        # played under (None: no chunk yet).
        self._min_weights_version: "int | None" = None
        self._out: list = []
        self._row_moves = 0  # the harvest's moves so far, two blocks each
        self._episode_scores: list[float] = []
        self._episode_lengths: list[int] = []
        self._episode_start_versions: list[int] = []
        self._episodes_played = 0
        self._episodes_truncated = 0
        self._total_simulations = 0
        self._total_reused_visits = 0  # root visits inherited through reuse
        self.dispatch_count = 0  # chunks played through play_chunk
        # Host seconds blocked in the chunks' fetches; lock-guarded with
        # the dispatch count (the loop reads both from another thread).
        self.transfer_d2h_seconds = 0.0
        self._transfer_lock = threading.Lock()
        # The run's flight recorder; None writes no intent/seal records.
        self.flight = None
        self.last_trace: "dict[str, np.ndarray] | None" = None
        # The searches' stat-pack flag (snapshotted when they were built)
        # and the newest chunk's folded search and rollout legs.
        self.device_stats = self.mcts.device_stats
        self.last_device_stats: "dict | None" = None

    # --- one chunk on the device ------------------------------------------

    def _temperatures(self, step_counts: torch.Tensor) -> torch.Tensor:
        """Per-game move-indexed temperature."""
        cfg = self.config
        frac = torch.clamp(step_counts.to(torch.float32) / cfg.TEMPERATURE_ANNEAL_MOVES, max=1.0)
        return cfg.TEMPERATURE_INITIAL + frac * (cfg.TEMPERATURE_FINAL - cfg.TEMPERATURE_INITIAL)

    def _move_body(self, carry: RolloutCarry, version: int):
        """One lockstep move of all B games under weights `version`.
        Updates the carry's window tensors in place and returns (carry',
        this move's outputs)."""
        n = self.n_step
        w = carry.move_index % n
        states = carry.env
        keys = rng.split(carry.rng, 5)
        new_rng, k_search, k_select, k_reset, k_mode = keys[0], keys[1], keys[2], keys[3], keys[4]
        cfg = self.mcts_config

        # 1-2. Features for replay + the batched search: under playout
        # cap randomization one host draw per move (not per game) picks
        # the full or the fast search for every lane.
        grids, others = self.extractor.extract(states)
        final_tree = reused = None
        is_full = True
        if carry.tree is not None:
            # Subtree reuse: lanes with an invalid carry search afresh.
            out, final_tree, reused = self.mcts._search_carried(states, k_search, carry.tree)
        elif self.mcts_fast is None:
            out = self.mcts.search(states, k_search)
        else:
            is_full = rng.bernoulli(k_mode, cfg.full_search_prob)
            out = (self.mcts if is_full else self.mcts_fast).search(states, k_search)
        sims = cfg.max_simulations if is_full else cfg.fast_simulations
        if self.use_gumbel:
            policy = out.improved_policy
        else:
            policy = policy_target_from_visits(out.visit_counts, self.env.valid_action_mask(states))
        pweight = 1.0 if is_full else 0.0

        # 3. Mature the slot added n moves ago, bootstrapped with this
        # search's root value; fast moves' slots are dropped.
        mat_mask = carry.pend_active[:, w].clone()
        if self._drop_fast_rows:
            mat_mask &= carry.pend_pweight[:, w] > 0.5
        mat = {
            "grid": carry.pend_grid[:, w].clone(),
            "other": carry.pend_other[:, w].clone(),
            "policy": carry.pend_policy[:, w].clone(),
            "pw": carry.pend_pweight[:, w].clone(),
            "ret": carry.pend_return[:, w] + carry.pend_discount[:, w] * out.root_value,
            "mask": mat_mask,
        }
        pend_active = carry.pend_active
        pend_active[:, w] = False

        # 4. The action and one batched env step. PUCT: a temperature-
        # scheduled draw from the visits (greedy on fast moves); Gumbel:
        # the search's own selection.
        if self.use_gumbel:
            actions = out.selected_action
        else:
            temps = self._temperatures(states.step_count)
            if not is_full:
                temps = torch.zeros_like(temps)
            actions = select_action_from_visits(out.visit_counts, temps, k_select, self.lanes)
        # -1 (no root visits) only happens for finished games, where the
        # step is a no-op; live-game sentinels are counted and reported.
        sentinel_live = ((actions < 0) & ~states.done).sum(dtype=torch.int32)
        actions = actions.clamp(min=0)
        new_states, rewards, dones = self.env.step(states, actions)

        # 5. This move's experience into window slot w.
        carry.pend_grid[:, w] = grids
        carry.pend_other[:, w] = others
        carry.pend_policy[:, w] = policy
        carry.pend_pweight[:, w] = pweight
        carry.pend_return[:, w] = 0.0
        carry.pend_discount[:, w] = 1.0
        pend_active[:, w] = True

        # 6. Fold this move's reward into every pending experience.
        pend_return = carry.pend_return + torch.where(
            pend_active, carry.pend_discount * rewards[:, None], 0.0
        )
        pend_discount = torch.where(pend_active, carry.pend_discount * self.gamma, 1.0)

        # 7. Trailing flush for finished (or move-capped) games.
        step_counts = new_states.step_count
        truncated = ~dones & (step_counts >= self.config.MAX_EPISODE_MOVES)
        ending = dones | truncated
        flush_mask = pend_active & ending[:, None]
        if self._drop_fast_rows:
            flush_mask &= carry.pend_pweight > 0.5
        flush = {
            "grid": carry.pend_grid.clone(),
            "other": carry.pend_other.clone(),
            "policy": carry.pend_policy.clone(),
            "pw": carry.pend_pweight.clone(),
            "ret": pend_return.clone(),  # the next move writes its slot in place
            "mask": flush_mask,
        }
        pend_active = pend_active & ~ending[:, None]
        episode = {
            "ending": ending,
            "truncated": truncated,
            "score": new_states.score,
            "length": step_counts,
            "start_version": carry.episode_start_version,
        }

        # 8. Reset finished games in place; the batch never shrinks.
        reset_states = self.env.reset_where_done(new_states.replace(done=ending), k_reset, self.lanes)
        episode_start_version = torch.where(ending, version, carry.episode_start_version)

        # 9. Promote the played action's subtree for the next move; lanes
        # whose game ended start their next game fresh.
        new_tree = carry.tree
        if final_tree is not None:
            new_tree = self.mcts.promote(final_tree, actions)
            new_tree.valid = new_tree.valid & ~ending
        new_carry = RolloutCarry(
            env=reset_states,
            rng=new_rng,
            pend_grid=carry.pend_grid,
            pend_other=carry.pend_other,
            pend_policy=carry.pend_policy,
            pend_pweight=carry.pend_pweight,
            pend_return=pend_return,
            pend_discount=pend_discount,
            pend_active=pend_active,
            episode_start_version=episode_start_version,
            move_index=carry.move_index + 1,
            tree=new_tree,
        )
        outputs = {
            "mat": mat,
            "flush": flush,
            "episode": episode,
            "sentinel_live": sentinel_live,
            "trace": {
                "root_value": out.root_value,
                "reward": rewards,
                "ending": ending,
                "wasted_slots": out.wasted_slots,
                # Root visits inherited from the carried subtree (0 without reuse).
                "reused": reused if reused is not None else torch.zeros_like(out.root_value),
            },
            # Host values: the simulations this move ran and whether it
            # was a full (policy-training) search; `_chunk` stacks them.
            "mode": (sims, is_full),
        }
        if out.stats is not None:
            outputs["device_stats"] = out.stats  # stacked over the chunk's moves
        return new_carry, outputs

    def _inference_variables(self, live: LiveWeights) -> LiveWeights:
        """`live` as a chunk searches with it: itself under float32, else
        the same version and the net's memoized `InferenceNet` of it."""
        model = self.net.inference_model(live)
        if model is live.model:
            return live
        return LiveWeights(live.version, model, model.ready)

    @torch.no_grad()
    def _chunk(self, num_moves: int, carry: RolloutCarry, weights: "LiveWeights | None" = None):
        """`num_moves` lockstep moves searched with `weights` (the net's
        live weights at the inference precision when None, read once);
        returns (carry', outputs stacked over the moves)."""
        w = self._inference_variables(self.net.live) if weights is None else weights
        if isinstance(w.model, torch.nn.Module):
            w.model.eval()
            receive([*w.model.parameters(), *w.model.buffers()], w.ready)
        elif isinstance(w.model, InferenceNet):
            receive(w.model.tensors(), w.ready)
        self.mcts.model = w.model
        if self.mcts_fast is not None:
            self.mcts_fast.model = w.model
        moves = []
        for _ in range(num_moves):
            carry, outputs = self._move_body(carry, w.version)
            moves.append(outputs)
        modes = [m.pop("mode") for m in moves]
        stacked = _stack(moves)
        dev = self.device
        stacked["trace"]["sims"] = torch.tensor([m[0] for m in modes], dtype=torch.int32, device=dev)
        stacked["trace"]["is_full"] = torch.tensor([m[1] for m in modes], dtype=torch.bool, device=dev)
        return carry, stacked

    # --- host API ---------------------------------------------------------

    def play_chunk(self, num_moves: "int | None" = None, fetch_experiences: bool = True):
        """Advance every game `num_moves` moves. With
        `fetch_experiences=False` the experience blocks stay on the
        device and are returned as the payload for
        `DeviceReplayBuffer.ingest_payload`; only the episode stats and
        the trace are fetched (one copy). Returns that payload, or None."""
        t = int(num_moves or self.config.ROLLOUT_CHUNK_MOVES)
        avals = f"B{self.batch_size}xT{t}"
        note_program_cost(f"self_play_chunk/t{t}", lambda: chunk_cost(self, t), avals, self.device.type)
        with flight_span(self.flight, "rollout", f"self_play_chunk/t{t}", avals=avals):
            note_dispatch(f"self_play_chunk/t{t}")
            weights = self._inference_variables(self.net.live)
            self.note_weights_version(weights.version)
            self._carry, outputs = self._chunk(t, self._carry, weights)
            payload = None
            if not fetch_experiences:
                payload = {"mat": outputs.pop("mat"), "flush": outputs.pop("flush")}
            t0 = time.perf_counter()
            # graftlint: allow(host-sync-in-hot-path) the chunk's one fetch
            host = fetch(outputs)  # the chunk's one transfer: the seal waits for it
            dt = time.perf_counter() - t0
        with self._transfer_lock:
            self.transfer_d2h_seconds += dt
            self.dispatch_count += 1
        self.fold_chunk_stats(host)
        if self.device_stats:
            # The search leg from the fetched packs; the rollout leg is a
            # host fold over arrays the same fetch carried.
            self.last_device_stats = {
                "search": fold_search_stats(unpack_search_stats(host.get("device_stats"))),
                "rollout": rollout_chunk_stats(host["episode"]["ending"], host["trace"]["reward"]),
            }
        if payload is not None:
            return payload
        for i, block in enumerate((host["mat"], host["flush"])):
            m = block["mask"]  # (T, B)
            if m.any():
                self._out.append(
                    (
                        block["grid"][m],
                        block["other"][m],
                        block["policy"][m],
                        block["ret"][m].astype(np.float32),
                        block["pw"][m].astype(np.float32),
                        self._row_moves + i * t + np.nonzero(m)[0],
                    )
                )
        self._row_moves += 2 * t
        return None

    def note_weights_version(self, version: int) -> None:
        """A chunk of the current harvest window plays under `version`."""
        if self._min_weights_version is None or version < self._min_weights_version:
            self._min_weights_version = version

    def fold_chunk_stats(self, host: dict) -> None:
        """The host tail of a chunk, over its fetched outputs: trace,
        simulation counts, episode stats, the sentinel warning."""
        self._total_simulations += int(host["trace"]["sims"].sum()) * self.batch_size
        self._total_reused_visits += int(host["trace"]["reused"].sum())
        self.last_trace = host["trace"]
        self._fold_episode_stats(host["episode"])
        sentinels = int(host["sentinel_live"].sum())
        if sentinels:
            logger.warning(
                "SelfPlay: %d zero-visit sentinel actions on LIVE games (clamped to action 0).",
                sentinels,
            )

    def _fold_episode_stats(self, episode: dict) -> None:
        """Accumulate finished-episode stats from one chunk's outputs."""
        ending = episode["ending"]  # (T, B)
        if ending.any():
            self._episode_scores.extend(episode["score"][ending].astype(float).tolist())
            self._episode_lengths.extend(episode["length"][ending].astype(int).tolist())
            self._episode_start_versions.extend(
                episode["start_version"][ending].astype(int).tolist()
            )
            self._episodes_played += int(ending.sum())
            self._episodes_truncated += int(episode["truncated"][ending].sum())

    def play_moves(self, num_moves: int) -> SelfPlayResult:
        """Advance all games `num_moves` moves and harvest experiences."""
        self.play_chunk(num_moves)
        return self.harvest()

    def play_moves_device(self, num_moves: int) -> tuple[SelfPlayResult, dict]:
        """Device-replay variant of `play_moves`: experiences stay on the
        device. Returns (stats-only harvest, device payload)."""
        payload = self.play_chunk(num_moves, fetch_experiences=False)
        return self.harvest(), payload

    def harvest(self) -> SelfPlayResult:
        """Collect emitted experiences + episode stats since the last call."""
        if self._out:
            cols = [np.concatenate([o[i] for o in self._out]) for i in range(6)]
        else:
            c, h, w = self._grid_shape
            cols = [
                np.zeros((0, c, h, w), np.float32),
                np.zeros((0, self._other_dim), np.float32),
                np.zeros((0, self._action_dim), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.int64),
            ]
        result = SelfPlayResult(
            grid=cols[0],
            other_features=cols[1],
            policy_target=cols[2],
            value_target=cols[3],
            policy_weight=cols[4],
            episode_scores=self._episode_scores,
            episode_lengths=self._episode_lengths,
            episode_start_versions=self._episode_start_versions,
            num_episodes=self._episodes_played,
            num_truncated=self._episodes_truncated,
            total_simulations=self._total_simulations,
            total_reused_visits=self._total_reused_visits,
            trainer_step_at_episode_start=(
                self._min_weights_version
                if self._min_weights_version is not None
                else self.net.live.version
            ),
            context={"row_moves": cols[5]},
        )
        self._out = []
        self._row_moves = 0
        self._episode_scores = []
        self._episode_lengths = []
        self._episode_start_versions = []
        self._min_weights_version = None
        self._episodes_played = 0
        self._episodes_truncated = 0
        self._total_simulations = 0
        self._total_reused_visits = 0
        return result
