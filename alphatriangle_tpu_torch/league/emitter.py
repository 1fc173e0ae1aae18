"""Trajectory emitter: counterpart of `alphatriangle_tpu/league/emitter.py`.
Served games become replay-ready harvests.

Every move served through `PolicyService.dispatch` can be harvested as a
(state features, visit-count policy, outcome) row in the layout the
replay ring's `add_dense` ingests, tagged with the service's reload
count (`PolicyService.weight_reloads`) of the weights that played it.
The emitter is off by default: a service without one serves as before.
A closed session becomes a one-episode `SelfPlayResult`, so the training
loop's `_fold_result` ingests served data as it ingests self-play.

Each dispatch extracts the pre-step states' features on the device and
fetches features and policy targets to the host in one copy.
"""

import logging
import threading

import numpy as np
import torch

from ..mcts.helpers import policy_target_from_visits
from ..rl.types import SelfPlayResult

logger = logging.getLogger(__name__)

_stale_warned = False


class TrajectoryEmitter:
    """Harvests per-move rows from a `PolicyService`'s dispatches.

    Wire by assigning to `service.emitter`: the service calls
    `on_dispatch` once per dispatch and `on_session_close` when a
    session retires. Finished episodes accumulate until `drain()`.
    Policy targets are the visit-count distributions of a PUCT search."""

    def __init__(self, env, extractor, gamma: float = 1.0):
        self.env = env
        self.extractor = extractor
        self.gamma = float(gamma)
        # sid -> per-move row lists (grid/other/policy/reward/version).
        self._open: dict[int, dict] = {}
        self._done: list[SelfPlayResult] = []
        self.moves_emitted = 0
        self.episodes_emitted = 0
        # Guards the finished-episode list: the service thread appends in
        # on_session_close while a learner thread swaps it in drain().
        self._lock = threading.Lock()

    # --- service hooks ----------------------------------------------------

    def on_dispatch(self, states, out, served, rewards_np, dones_np, version: int) -> None:
        """One dispatch: `states` are the pre-step states (the positions
        the search ran on), `served` the Session handles served, `version`
        the service's reload count, every row's staleness tag."""
        with torch.no_grad():
            grids, others = self.extractor.extract(states)
            policy = policy_target_from_visits(
                out.visit_counts, self.env.valid_action_mask(states)
            )
            b = grids.shape[0]
            packed = torch.cat(
                [grids.reshape(b, -1).float(), others.float(), policy.float()], dim=1
            ).cpu().numpy()
        n_grid = int(np.prod(grids.shape[1:]))
        n_other = others.shape[1]
        grid_np = packed[:, :n_grid].reshape(grids.shape)
        other_np = packed[:, n_grid:n_grid + n_other]
        policy_np = packed[:, n_grid + n_other:]
        for s in served:
            rows = self._open.setdefault(
                s.sid, {"grid": [], "other": [], "policy": [], "reward": [], "version": []}
            )
            rows["grid"].append(grid_np[s.slot])
            rows["other"].append(other_np[s.slot])
            rows["policy"].append(policy_np[s.slot])
            rows["reward"].append(float(rewards_np[s.slot]))
            rows["version"].append(int(version))

    def on_session_close(self, sid: int, summary: dict) -> None:
        """A session retired: fold its moves into one episode harvest
        whose value targets are the discounted Monte-Carlo returns
        ret[t] = sum_k gamma^k r[t+k]."""
        rows = self._open.pop(sid, None)
        if not rows or not rows["grid"]:
            return
        rewards = np.asarray(rows["reward"], dtype=np.float32)
        returns = np.empty_like(rewards)
        acc = 0.0
        for t in range(len(rewards) - 1, -1, -1):
            acc = rewards[t] + self.gamma * acc
            returns[t] = acc
        result = SelfPlayResult(
            grid=np.stack(rows["grid"]).astype(np.float32),
            other_features=np.stack(rows["other"]),
            policy_target=np.stack(rows["policy"]),
            value_target=returns,
            episode_scores=[float(summary.get("score", 0.0))],
            episode_lengths=[len(rewards)],
            episode_start_versions=[rows["version"][0]],
            num_episodes=1,
            num_truncated=0 if summary.get("done") else 1,
            trainer_step_at_episode_start=rows["version"][0],
            context={"source": "league", "row_versions": list(rows["version"])},
        )
        with self._lock:
            self.episodes_emitted += 1
            self.moves_emitted += result.num_experiences
            self._done.append(result)

    # --- harvest ----------------------------------------------------------

    def drain(self) -> "SelfPlayResult | None":
        """Every episode finished since the last drain, merged into one
        harvest (None when none finished)."""
        with self._lock:
            results, self._done = self._done, []
        return merge_results(results)


def merge_results(results: list) -> "SelfPlayResult | None":
    """Concatenate per-episode harvests into one dense block, their
    `row_versions` included."""
    results = [r for r in results if r is not None and r.num_experiences]
    if not results:
        return None
    return SelfPlayResult(
        grid=np.concatenate([r.grid for r in results]),
        other_features=np.concatenate([r.other_features for r in results]),
        policy_target=np.concatenate([r.policy_target for r in results]),
        value_target=np.concatenate([r.value_target for r in results]),
        policy_weight=np.concatenate([r.policy_weight for r in results]),
        episode_scores=[s for r in results for s in r.episode_scores],
        episode_lengths=[x for r in results for x in r.episode_lengths],
        episode_start_versions=[v for r in results for v in r.episode_start_versions],
        num_episodes=sum(r.num_episodes for r in results),
        num_truncated=sum(r.num_truncated for r in results),
        total_simulations=sum(r.total_simulations for r in results),
        trainer_step_at_episode_start=min(r.trainer_step_at_episode_start for r in results),
        context={
            "source": "league",
            "row_versions": [
                v
                for r in results
                for v in r.context.get(
                    "row_versions", [r.trainer_step_at_episode_start] * r.num_experiences
                )
            ],
        },
    )


def apply_staleness_guard(
    result: "SelfPlayResult | None", clock: int, window: "int | None"
) -> "tuple[SelfPlayResult | None, int]":
    """Drop the rows whose weights version trails `clock` by more than
    `window` reloads: (kept result or None, dropped count). A `window`
    of None or below 0 keeps everything; so does a row / version count
    mismatch (the validator dropped rows). Warns once."""
    global _stale_warned
    if result is None or window is None or window < 0:
        return result, 0
    versions = np.asarray(
        result.context.get(
            "row_versions", [result.trainer_step_at_episode_start] * result.num_experiences
        ),
        dtype=np.int64,
    )
    if versions.shape[0] != result.num_experiences:
        return result, 0
    keep = (int(clock) - versions) <= int(window)
    dropped = int((~keep).sum())
    if dropped == 0:
        return result, 0
    if not _stale_warned:
        _stale_warned = True
        logger.warning(
            "Staleness guard: dropping %d of %d league rows more than %d reloads behind the "
            "learner (warn-once; see Stats/stale_dropped).",
            dropped, result.num_experiences, window,
        )
    if keep.sum() == 0:
        return None, dropped
    kept = SelfPlayResult(
        grid=result.grid[keep],
        other_features=result.other_features[keep],
        policy_target=result.policy_target[keep],
        value_target=result.value_target[keep],
        policy_weight=result.policy_weight[keep] if result.policy_weight is not None else None,
        episode_scores=result.episode_scores,
        episode_lengths=result.episode_lengths,
        episode_start_versions=result.episode_start_versions,
        num_episodes=result.num_episodes,
        num_truncated=result.num_truncated,
        total_simulations=result.total_simulations,
        trainer_step_at_episode_start=result.trainer_step_at_episode_start,
        context={**result.context, "row_versions": versions[keep].tolist()},
    )
    return kept, dropped
