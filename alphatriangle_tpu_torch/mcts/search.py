"""Batched wave-parallel PUCT search: counterpart of the fresh-root path
of `alphatriangle_tpu/mcts/search.py` (`Tree`, `SearchOutput`,
`_evaluate`, `_init_tree`, `_descend_wave`, `_wave`, `_run_waves`,
`_output_from_tree`, `_search`).

A search over B games runs eagerly on one device. Tree statistics are
edge-indexed (B, N, A) planes; simulations run in waves of W members:

1. W parallel PUCT descents per tree over `max_depth` levels. Each
   level reads W tree rows per game from the (B, N, 6A) concatenation
   of the six stat planes through `ops.gather_rows` (the hand-written
   kernel on the card), and diversifies members with Gumbel noise.
2. One batched `env.step` over the B*W selected edges.
3. One network evaluation of all B*W leaves.
4. Block insertion of the W new node slots; duplicate edges within a
   wave are canonicalised to one child.
5. Child insertion and the discounted backup along the recorded paths
   through `ops.backup_update` (the hand-written kernel on the card),
   which updates the planes in place.

The key schedule is the JAX package's: `split(rng, 3)` into (rng,
noise, wave) keys, `fold_in(wave_rng, k)` per wave and `fold_in(.., d)`
per descent level. The noise draws go through `rng.gumbel` and
`rng.gamma` (looked up on the module at call time, so tests can
substitute JAX's draws). Subtree reuse, Gumbel root search and the
device stat-pack wait for later slices: a config asking for them is
refused, and `SearchOutput.stats` stays None.

Each stage of a wave runs under a `torch.profiler.record_function`
label (`search.init_tree`, `search.descend`, `search.expand`,
`search.evaluate`, `search.backup`), which a profiler reads as the
stage's host and device time and which costs a few microseconds
otherwise.
"""

from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from .. import rng
from ..config.mcts_config import MCTSConfig
from ..env.engine import EnvState, TriangleEnv
from ..features.core import FeatureExtractor
from ..ops import backup_update, gather_rows
from ..ops.gather_rows import MODES as GATHER_MODES
from ..ops.mcts_backup import MODES as BACKUP_MODES


@dataclass
class Tree:
    """Edge-indexed search tensors, batched over B games."""

    node_state: EnvState  # (B, N, ...) game state at each node slot
    e_visits: torch.Tensor  # (B, N, A) f32 edge visit counts
    e_value: torch.Tensor  # (B, N, A) f32 sum of discounted returns
    e_reward: torch.Tensor  # (B, N, A) f32 reward on the edge
    children: torch.Tensor  # (B, N, A) f32 child slot id; -1 = unexpanded
    prior: torch.Tensor  # (B, N, A) f32 masked policy priors
    valid: torch.Tensor  # (B, N, A) f32 1.0 where the action is valid
    terminal: torch.Tensor  # (B, N) bool
    root_value0: torch.Tensor  # (B,) f32 network value of the root


@dataclass
class SearchOutput:
    """Result of one batched search."""

    visit_counts: torch.Tensor  # (B, A) f32 root child visit counts
    root_value: torch.Tensor  # (B,) f32 mean backed-up root value
    root_prior: torch.Tensor  # (B, A) f32 noisy root prior
    total_simulations: int
    wasted_slots: torch.Tensor  # (B,) int32 orphan node slots
    selected_action: torch.Tensor  # (B,) int32; -1 = select from visits
    improved_policy: torch.Tensor  # (B, A) f32 zeros under PUCT
    stats: Any = None


class BatchedMCTS:
    """PUCT search bound to (env, features, model).

    `model(grid, other) -> (policy_logits, value_logits)` is any callable
    on the env's device (the `AlphaTriangleNet` of a `NeuralNetwork`,
    or a stub in tests); `value_support` is the C51 atom support.
    """

    def __init__(
        self,
        env: TriangleEnv,
        extractor: FeatureExtractor,
        model,
        config: MCTSConfig,
        value_support: torch.Tensor,
    ):
        if config.tree_reuse:
            raise ValueError("tree_reuse is not ported yet; this search is fresh-root")
        if config.root_selection != "puct":
            raise ValueError("only root_selection='puct' is ported yet")
        if config.descent_gather not in GATHER_MODES:
            raise ValueError(f"unknown gather mode: {config.descent_gather!r}")
        if config.backup_update not in BACKUP_MODES:
            raise ValueError(f"unknown backup mode: {config.backup_update!r}")
        self.env = env
        self.device = env.device
        self.extractor = extractor
        self.model = model
        self.config = config
        self.support = value_support.to(self.device)
        self.num_nodes = config.max_simulations + 1
        self.action_dim = env.action_dim
        # Wave size: the largest divisor of max_simulations that is
        # <= mcts_batch_size, so waves tile the simulation budget.
        w = max(1, min(config.mcts_batch_size, config.max_simulations))
        while config.max_simulations % w:
            w -= 1
        self.wave_size = w
        self.num_waves = config.max_simulations // w

    # --- network evaluation ----------------------------------------------

    def _evaluate(self, states: EnvState):
        """Leaf eval: states (M-leading) -> (priors (M,A), values (M,),
        valid (M,A)). Priors are masked to valid actions and
        renormalised, uniform over valid where the mass vanishes."""
        grids, others = self.extractor.extract(states)
        policy_logits, value_logits = self.model(grids, others)
        valid = self.env.valid_action_mask(states)
        neg_inf = torch.tensor(float("-inf"), device=self.device)
        zero = torch.zeros((), device=self.device)
        masked = torch.where(valid, policy_logits, neg_inf)
        any_valid = valid.any(dim=-1, keepdim=True)
        priors = torch.softmax(torch.where(any_valid, masked, zero), dim=-1)
        priors = torch.where(valid, priors, zero)
        norm = priors.sum(dim=-1, keepdim=True)
        uniform = valid.to(torch.float32) / valid.sum(dim=-1, keepdim=True).clamp(min=1)
        priors = torch.where(norm > 1e-9, priors / norm.clamp(min=1e-9), uniform)
        values = (torch.softmax(value_logits, dim=-1) * self.support).sum(dim=-1)
        return priors, values, valid

    # --- the search -------------------------------------------------------

    def _init_tree(self, root_states: EnvState, noise_rng: torch.Tensor) -> Tree:
        """Root eval + Dirichlet noise; every node slot starts as the root."""
        cfg = self.config
        batch = root_states.done.shape[0]
        n, a = self.num_nodes, self.action_dim
        dev = self.device
        priors, values, valid = self._evaluate(root_states)
        zero = torch.zeros((), device=dev)
        root_value = torch.where(root_states.done, zero, values)
        if cfg.dirichlet_epsilon > 0 and cfg.dirichlet_alpha > 0:
            gammas = rng.gamma(noise_rng, cfg.dirichlet_alpha, (batch, a), device=dev)
            gammas = torch.where(valid, gammas, zero)
            noise = gammas / gammas.sum(dim=-1, keepdim=True).clamp(min=1e-9)
            priors = (1.0 - cfg.dirichlet_epsilon) * priors + cfg.dirichlet_epsilon * noise
            priors = torch.where(valid, priors, zero)

        node_state = root_states.map(
            lambda x: x[:, None].expand((batch, n) + tuple(x.shape[1:])).clone()
        )
        planes = torch.zeros((4, batch, n, a), dtype=torch.float32, device=dev)
        prior = torch.zeros((batch, n, a), dtype=torch.float32, device=dev)
        prior[:, 0] = priors
        valid_p = torch.zeros((batch, n, a), dtype=torch.float32, device=dev)
        valid_p[:, 0] = valid.to(torch.float32)
        terminal = torch.zeros((batch, n), dtype=torch.bool, device=dev)
        terminal[:, 0] = root_states.done
        return Tree(
            node_state=node_state,
            e_visits=planes[0],
            e_value=planes[1],
            e_reward=planes[2],
            children=planes[3].fill_(-1.0),
            prior=prior,
            valid=valid_p,
            terminal=terminal,
            root_value0=root_value,
        )

    def _descend_wave(self, tree: Tree, wave_rng: torch.Tensor, batch: int) -> dict:
        """W parallel recorded descents per tree: final (parent, action,
        existing child) and the recorded path for the backup."""
        cfg = self.config
        w, a, depth = self.wave_size, self.action_dim, cfg.max_depth
        dev = self.device
        stats = torch.cat(
            [tree.e_visits, tree.e_value, tree.e_reward, tree.prior, tree.valid, tree.children],
            dim=-1,
        )  # (B, N, 6A)
        neg_inf = torch.tensor(float("-inf"), device=dev)
        zero = torch.zeros((), device=dev)
        node = torch.zeros((batch, w), dtype=torch.int64, device=dev)
        action = torch.zeros((batch, w), dtype=torch.int64, device=dev)
        stop = torch.zeros((batch, w), dtype=torch.bool, device=dev)
        rec_node = torch.full((batch, w, depth), -1, dtype=torch.int64, device=dev)
        rec_action = torch.full((batch, w, depth), -1, dtype=torch.int64, device=dev)
        rec_reward = torch.zeros((batch, w, depth), dtype=torch.float32, device=dev)
        rec_active = torch.zeros((batch, w, depth), dtype=torch.bool, device=dev)
        noisy = w > 1 and cfg.wave_noise_scale > 0
        for d in range(depth):
            rows = gather_rows(stats, node, mode=cfg.descent_gather)  # (B, W, 6A)
            visits_r, value_r, reward_r, prior_r, valid_r, child_r = rows.split(a, dim=-1)
            n_node = 1.0 + visits_r.sum(dim=-1, keepdim=True)
            q = torch.where(visits_r > 0, value_r / visits_r.clamp(min=1e-9), zero)
            u = cfg.cpuct * prior_r * torch.sqrt(n_node) / (1.0 + visits_r)
            scores = torch.where(valid_r > 0, q + u, neg_inf)
            if noisy:
                level_key = rng.fold_in(wave_rng, d)
                scores = scores + cfg.wave_noise_scale * rng.gumbel(
                    level_key, (batch, w, a), device=dev
                )
            act = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
            child = child_r.gather(-1, act[..., None])[..., 0].to(torch.int64)
            r_edge = reward_r.gather(-1, act[..., None])[..., 0]
            term = tree.terminal.gather(1, node)
            stop_now = (child < 0) | (d + 1 >= depth) | term
            active = ~stop
            rec_node[:, :, d] = torch.where(active, node, -1)
            rec_action[:, :, d] = torch.where(active, act, -1)
            rec_reward[:, :, d] = torch.where(active, r_edge, zero)
            rec_active[:, :, d] = active
            action = torch.where(stop, action, act)
            node = torch.where(stop | stop_now, node, child)
            stop = stop | stop_now
        existing = tree.children.reshape(batch, -1).gather(1, node * a + action).to(torch.int64)
        return {
            "parents": node,
            "actions": action,
            "existing": existing,
            "rec_node": rec_node,
            "rec_action": rec_action,
            "rec_reward": rec_reward,
            "rec_active": rec_active,
        }

    def _wave(self, batch: int, tree: Tree, wasted: torch.Tensor, base: int, wave_rng):
        """One wave: W parallel simulations across all B trees. Updates
        `tree` in place; returns (wasted, next base)."""
        cfg = self.config
        w, a, depth = self.wave_size, self.action_dim, cfg.max_depth
        dev = self.device
        zero = torch.zeros((), device=dev)
        warange = torch.arange(w, device=dev)
        bcol = torch.arange(batch, device=dev)[:, None]

        with record_function("search.descend"):
            d = self._descend_wave(tree, wave_rng, batch)
        parents, actions, existing = d["parents"], d["actions"], d["existing"]
        is_new = existing < 0

        # Members that chose the same edge share one child: the one of
        # the highest member index (matching the insertion's max).
        key = parents * a + actions
        same = key[:, :, None] == key[:, None, :]
        later = warange[None, None, :] > warange[None, :, None]
        is_canon = ~(same & later).any(dim=-1)

        # Expansion: one env.step over all B*W edges (deterministic per
        # node key, so duplicate and revisited edges give the same child).
        with record_function("search.expand"):
            parent_states = tree.node_state.map(
                lambda x: x[bcol, parents].reshape((batch * w,) + tuple(x.shape[2:]))
            )
            new_states, rewards, dones = self.env.step(parent_states, actions.reshape(-1))
        rewards = rewards.reshape(batch, w)
        dones = dones.reshape(batch, w)

        with record_function("search.evaluate"):
            priors, values, valid = self._evaluate(new_states)
        leaf_values = torch.where(dones, zero, values.reshape(batch, w))

        # Insert the wave's W node slots as one block at [base, base+W).
        for name in tree.node_state.__dataclass_fields__:
            buf = getattr(tree.node_state, name)
            x = getattr(new_states, name)
            buf[:, base : base + w] = x.reshape((batch, w) + tuple(x.shape[1:]))
        tree.prior[:, base : base + w] = priors.reshape(batch, w, a)
        tree.valid[:, base : base + w] = valid.reshape(batch, w, a).to(torch.float32)
        tree.terminal[:, base : base + w] = dones
        slot_ids = (base + warange[None, :]).to(torch.float32)  # (1, W)
        live = is_new & is_canon

        # Suffix returns G_d = r_d + discount * G_{d+1}; the deepest
        # active level takes the fresh step reward.
        rec_active = d["rec_active"]
        last_idx = rec_active.sum(dim=-1) - 1
        g = leaf_values
        contrib = []
        for lvl in range(depth - 1, -1, -1):
            act_l = rec_active[:, :, lvl]
            r_lvl = torch.where(act_l & (last_idx == lvl), rewards, d["rec_reward"][:, :, lvl])
            g = torch.where(act_l, r_lvl + cfg.discount * g, g)
            contrib.append(g)
        contrib.reverse()

        with record_function("search.backup"):
            backup_update(
                tree.e_visits,
                tree.e_value,
                tree.children,
                tree.e_reward,
                parents,
                actions,
                torch.where(is_new, slot_ids, torch.tensor(-1.0, device=dev)),
                rewards,
                d["rec_node"],
                d["rec_action"],
                rec_active,
                torch.stack(contrib, dim=-1),
                mode=cfg.backup_update,
            )
        wasted = wasted + (w - live.sum(dim=1, dtype=torch.int32))
        return wasted, base + w

    def _run_waves(self, batch: int, tree: Tree, wave_rng: torch.Tensor):
        wasted = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        base = 1
        for k in range(self.num_waves):
            wasted, base = self._wave(batch, tree, wasted, base, rng.fold_in(wave_rng, k))
        return wasted

    def _output_from_tree(self, tree: Tree, wasted: torch.Tensor, batch: int) -> SearchOutput:
        """Root stats are row 0 of the edge planes."""
        visit_counts = tree.e_visits[:, 0, :].clone()
        root_visits = 1.0 + visit_counts.sum(dim=-1)
        root_value = (tree.root_value0 + tree.e_value[:, 0, :].sum(dim=-1)) / root_visits
        return SearchOutput(
            visit_counts=visit_counts,
            root_value=root_value,
            root_prior=tree.prior[:, 0].clone(),
            total_simulations=self.config.max_simulations * batch,
            wasted_slots=wasted,
            selected_action=torch.full((batch,), -1, dtype=torch.int32, device=self.device),
            improved_policy=torch.zeros_like(visit_counts),
        )

    @torch.no_grad()
    def search(self, root_states: EnvState, key: torch.Tensor) -> SearchOutput:
        """Run `max_simulations` batched simulations from `root_states`;
        `key` is one (2,) key on the CPU."""
        batch = root_states.done.shape[0]
        keys = rng.split(key, 3)
        noise_rng, wave_rng = keys[1], keys[2]
        with record_function("search.init_tree"):
            tree = self._init_tree(root_states, noise_rng)
        wasted = self._run_waves(batch, tree, wave_rng)
        return self._output_from_tree(tree, wasted, batch)
