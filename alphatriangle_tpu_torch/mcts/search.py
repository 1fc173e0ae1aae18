"""Batched wave-parallel PUCT search: counterpart of the PUCT path of
`alphatriangle_tpu/mcts/search.py` (`Tree`, `CarriedTree`,
`SearchOutput`, `_evaluate`, `_init_tree`, `_descend_wave`, `_wave`,
`_run_waves`, `_output_from_tree`, `_search`, `_search_carried`,
`promote`, `zero_carried`).

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
substitute JAX's draws). A wave may force each member's depth-0 action
(`root_action`), which the Gumbel root search (mcts/gumbel.py,
`GumbelMCTS`) uses to spread a wave over its candidates.

Device stat-packs (`telemetry/device_stats.py`): an engine built while
`device_stats_enabled()` holds carries an int64 leaf-depth histogram
through its waves (one count per member, at its descent depth clipped to
`DEPTH_BINS - 1`: an exact `index_add_` of integers, with no host sync)
and returns `SearchOutput.stats`, one float64 (SEARCH_PACK_SIZE,) tensor
(`_stat_pack`: the histogram, root-visit entropy and concentration, the
largest |Q| or root value, tree occupancy and the reused share of the
root visits), computed with plain reductions on the card and fetched by
the caller's existing copy. Otherwise `stats` stays None and the waves
run as before. Each wave is a beacon site (`search_wave`, every
`beacon_every()`th wave), which launches nothing unless beacons are
armed.

Subtree reuse (`MCTSConfig.tree_reuse`) widens the node budget to
`max_simulations + tree_reuse_budget + 1` rows. After a move,
`promote` compacts the played child's subtree into the leading rows
(`ops.subtree_promote`, whose row reorder is the hand-written kernel on
the card); the next `_search_carried` merges those edge statistics
under a fresh root evaluation and inserts its waves at a per-game base.
The `CarriedTree` rides the caller's carry (the rollout carry, the
service's lanes).

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
from . import helpers
from ..config.mcts_config import MCTSConfig
from ..env.engine import EnvState, TriangleEnv
from ..features.core import FeatureExtractor
from ..nn import precision
from ..ops import backup_update, gather_rows, subtree_promote
from ..ops.gather_rows import MODES as GATHER_MODES
from ..ops.mcts_backup import MODES as BACKUP_MODES
from ..ops.subtree_reuse import MODES as REUSE_MODES
from ..telemetry import device_stats
from ..telemetry.device_stats import DEPTH_BINS


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
class CarriedTree:
    """A promoted search tree carried across moves (subtree reuse).

    `tree` holds the chosen child's subtree in the leading rows (BFS
    order, freed rows zeroed); `valid[b]` gates the merge (False: the
    next search starts fresh); `base[b]` is the retained row count, the
    next search's insertion base."""

    tree: Tree
    valid: torch.Tensor  # (B,) bool
    base: torch.Tensor  # (B,) int64


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
    stats: Any = None  # (SEARCH_PACK_SIZE,) f64 stat-pack when device stats are on


class BatchedMCTS:
    """PUCT search bound to (env, features, model).

    `model(grid, other) -> (policy_logits, value_logits)` is any callable
    on the env's device (the `AlphaTriangleNet` of a `NeuralNetwork`,
    or a stub in tests) or a reduced-precision `nn.precision.InferenceNet`,
    which `_evaluate` runs through `precision.apply`; `value_support` is
    the C51 atom support.
    """

    def __init__(
        self,
        env: TriangleEnv,
        extractor: FeatureExtractor,
        model,
        config: MCTSConfig,
        value_support: torch.Tensor,
    ):
        if config.descent_gather not in GATHER_MODES:
            raise ValueError(f"unknown gather mode: {config.descent_gather!r}")
        if config.backup_update not in BACKUP_MODES:
            raise ValueError(f"unknown backup mode: {config.backup_update!r}")
        if config.tree_reuse_backend not in REUSE_MODES:
            raise ValueError(f"unknown tree reuse mode: {config.tree_reuse_backend!r}")
        self.env = env
        self.device = env.device
        self.extractor = extractor
        self.model = model
        self.config = config
        # A dp rank's rows of the engine's lane array (rng.Lanes): its
        # lane-dimension draws are the global array's at its rows.
        self.lanes: "rng.Lanes | None" = None
        self.support = value_support.to(self.device)
        # Reuse keeps up to `reuse_slots` promoted rows (the subtree and
        # its root) besides a full search's insertions.
        if config.tree_reuse:
            self.reuse_slots = (config.tree_reuse_budget or config.max_simulations) + 1
        else:
            self.reuse_slots = 1
        self.num_nodes = config.max_simulations + self.reuse_slots
        self.action_dim = env.action_dim
        # Wave size: the largest divisor of max_simulations that is
        # <= mcts_batch_size, so waves tile the simulation budget.
        w = max(1, min(config.mcts_batch_size, config.max_simulations))
        while config.max_simulations % w:
            w -= 1
        self.wave_size = w
        self.num_waves = config.max_simulations // w
        # The stat-pack flag when the engine is built (as the JAX engine
        # snapshots it); a live engine never flips it.
        self.device_stats = device_stats.device_stats_enabled()
        self._hist_ones: dict = {}  # members per wave -> int64 ones, for the histogram

    # --- network evaluation ----------------------------------------------

    def _evaluate(self, states: EnvState):
        """Leaf eval: states (M-leading) -> (priors (M,A), values (M,),
        valid (M,A)). Priors are masked to valid actions and
        renormalised, uniform over valid where the mass vanishes."""
        grids, others = self.extractor.extract(states)
        # The choke point of the inference precision policy: an int8
        # copy dequantizes here, once per evaluation (nn/precision.py).
        policy_logits, value_logits = precision.apply(self.model, grids, others)
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
            gammas = rng.gamma(noise_rng, cfg.dirichlet_alpha, (batch, a), device=dev, lanes=self.lanes)
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

    def _descend_wave(
        self, tree: Tree, wave_rng: torch.Tensor, batch: int, root_action=None
    ) -> dict:
        """W parallel recorded descents per tree: final (parent, action,
        existing child) and the recorded path for the backup.
        `root_action` (B, W), when given, forces each member's depth-0
        action where it is >= 0; -1 leaves the member to PUCT, and
        deeper levels always select by PUCT."""
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
                    level_key, (batch, w, a), device=dev, lanes=self.lanes
                )
            act = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
            if d == 0 and root_action is not None:
                act = torch.where(root_action >= 0, root_action, act)
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

    def _wave(
        self, batch: int, tree: Tree, wasted: torch.Tensor, base, wave_rng, root_action=None,
        hist=None,
    ):
        """One wave: W parallel simulations across all B trees. `base` is
        the first insertion row, an int (fresh root) or a (B,) tensor
        (reuse: each game retained its own row count); `root_action` as
        in `_descend_wave`; `hist`, when given, the (DEPTH_BINS,) int64
        depth histogram, counted into in place. Updates `tree` in place;
        returns (wasted, next base)."""
        cfg = self.config
        w, a, depth = self.wave_size, self.action_dim, cfg.max_depth
        dev = self.device
        zero = torch.zeros((), device=dev)
        warange = torch.arange(w, device=dev)
        bcol = torch.arange(batch, device=dev)[:, None]

        with record_function("search.descend"):
            d = self._descend_wave(tree, wave_rng, batch, root_action)
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

        # Insert the wave's W node slots as one block at [base, base+W):
        # a slice for a shared base, rows [base_b, base_b+W) per game else.
        if isinstance(base, int):
            at = (slice(None), slice(base, base + w))
            slot_ids = (base + warange[None, :]).to(torch.float32)  # (1, W)
        else:
            slots = base[:, None] + warange[None, :]  # (B, W)
            at = (bcol, slots)
            slot_ids = slots.to(torch.float32)
        for name in tree.node_state.__dataclass_fields__:
            buf = getattr(tree.node_state, name)
            x = getattr(new_states, name)
            buf[at] = x.reshape((batch, w) + tuple(x.shape[1:]))
        tree.prior[at] = priors.reshape(batch, w, a)
        tree.valid[at] = valid.reshape(batch, w, a).to(torch.float32)
        tree.terminal[at] = dones
        live = is_new & is_canon

        # Suffix returns G_d = r_d + discount * G_{d+1}; the deepest
        # active level takes the fresh step reward.
        rec_active = d["rec_active"]
        last_idx = rec_active.sum(dim=-1) - 1
        if hist is not None:
            # One count per member at its descent depth (a terminal root
            # counts in bin 0; depths past the last bin clip into it).
            d_bin = last_idx.clamp(0, DEPTH_BINS - 1).reshape(-1)
            hist.index_add_(0, d_bin, self._ones(d_bin.numel()))
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

    def _ones(self, n: int) -> torch.Tensor:
        ones = self._hist_ones.get(n)
        if ones is None:
            ones = self._hist_ones[n] = torch.ones((n,), dtype=torch.int64, device=self.device)
        return ones

    def _stats_seed(self) -> "torch.Tensor | None":
        """The zeroed depth histogram the waves count into when device
        stats are on; None when they are off."""
        if not self.device_stats:
            return None
        return torch.zeros((DEPTH_BINS,), dtype=torch.int64, device=self.device)

    def beacon(self, k: int) -> None:
        """The `search_wave` beacon site of wave `k`."""
        device_stats.emit_beacon("search_wave", k, every=device_stats.beacon_every(), device=self.device)

    def _run_waves(self, batch: int, tree: Tree, wave_rng: torch.Tensor, base=1):
        """`num_waves` waves from `tree`, the first inserting at `base`
        (an int, or a (B,) tensor under reuse); returns (wasted slots,
        the final base, the depth histogram or None)."""
        wasted = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        hist = self._stats_seed()
        for k in range(self.num_waves):
            self.beacon(k)
            wasted, base = self._wave(batch, tree, wasted, base, rng.fold_in(wave_rng, k), hist=hist)
        return wasted, base, hist

    def _stat_pack(self, tree: Tree, wasted, final_base, hist, batch: int, reused=None) -> torch.Tensor:
        """The search's stat-pack from tensors already on the device: the
        depth histogram, then `SEARCH_SCALARS` (mean root-visit entropy
        and concentration, the largest |Q| over visited root edges or
        |root value|, mean occupancy of the node rows, the mean share of
        root visits inherited through reuse), packed as one float64
        tensor. The per-game values are the JAX `_stat_pack`'s float32
        ones; their means over the games are taken in float64, where the
        sum of the concentrations, occupancies and reused shares (float32
        values of 0 or in [2^-11, 1], at most 2^16 of them) is exact in
        any order, so the card and the CPU give the same bits (the JAX
        package's float32 means round on the order of XLA's sum)."""
        visits = tree.e_visits[:, 0, :]  # (B, A) root edge visits
        total = visits.sum(dim=-1)
        p = visits / total.clamp(min=1.0)[:, None]
        entropy = -torch.where(p > 0, p * torch.log(p.clamp(min=1e-12)), 0.0).sum(dim=-1)
        q_abs = torch.where(visits > 0, tree.e_value[:, 0, :].abs() / visits.clamp(min=1e-9), 0.0)
        value_abs_max = torch.maximum(q_abs.max(), tree.root_value0.abs().max())
        if isinstance(final_base, int):
            live = float(final_base) - wasted.to(torch.float32)
        else:
            live = final_base.to(torch.float32) - wasted.to(torch.float32)
        if reused is None:
            reuse_frac = torch.zeros((), device=self.device)
        else:
            reuse_frac = (reused / total.clamp(min=1.0)).to(torch.float64).mean()
        f64 = torch.float64
        scalars = torch.stack([
            entropy.to(f64).mean(),
            p.amax(dim=-1).to(f64).mean(),
            value_abs_max.to(f64),
            (live / float(self.num_nodes)).to(f64).mean(),
            reuse_frac.to(f64),
        ])
        return torch.cat([hist.to(f64), scalars])

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

    def root_actions(self, output: SearchOutput) -> torch.Tensor:
        """The played action of each root (serving, the arena): the
        visit-count argmax."""
        return helpers.root_actions(output)

    @torch.no_grad()
    def search(self, root_states: EnvState, key: torch.Tensor) -> SearchOutput:
        """Run `max_simulations` batched simulations from `root_states`;
        `key` is one (2,) key on the CPU."""
        batch = root_states.done.shape[0]
        keys = rng.split(key, 3)
        noise_rng, wave_rng = keys[1], keys[2]
        with record_function("search.init_tree"):
            tree = self._init_tree(root_states, noise_rng)
        wasted, base, hist = self._run_waves(batch, tree, wave_rng)
        out = self._output_from_tree(tree, wasted, batch)
        if hist is not None:
            with record_function("search.stats"):
                out.stats = self._stat_pack(tree, wasted, base, hist, batch)
        return out

    # --- subtree reuse (MCTSConfig.tree_reuse; ops/subtree_reuse.py) ---

    @torch.no_grad()
    def _search_carried(self, root_states: EnvState, key: torch.Tensor, carried: CarriedTree):
        """`search` seeded with a promoted tree where `carried.valid`.

        Row 0 always comes from a fresh root evaluation (network value,
        masked priors with Dirichlet noise, the current state, validity
        and terminal), so reuse carries only edge statistics, child links
        and interior priors and states. Lanes with `valid=False` run the
        fresh-root search exactly. Returns `(output, final tree, reused)`,
        `reused[b]` the root visits inherited from the carry."""
        batch = root_states.done.shape[0]
        keys = rng.split(key, 3)
        noise_rng, wave_rng = keys[1], keys[2]
        with record_function("search.init_tree"):
            fresh = self._init_tree(root_states, noise_rng)
            ct = carried.tree
            ok = carried.valid

            def merge(c, f, pin_root=False):
                m = torch.where(ok.reshape((batch,) + (1,) * (c.dim() - 1)), c, f)
                if pin_root:
                    m[:, 0] = f[:, 0]
                return m

            tree = Tree(
                node_state=EnvState(
                    **{
                        name: merge(
                            getattr(ct.node_state, name), getattr(fresh.node_state, name), True
                        )
                        for name in fresh.node_state.__dataclass_fields__
                    }
                ),
                e_visits=merge(ct.e_visits, fresh.e_visits),
                e_value=merge(ct.e_value, fresh.e_value),
                e_reward=merge(ct.e_reward, fresh.e_reward),
                children=merge(ct.children, fresh.children),
                prior=merge(ct.prior, fresh.prior, True),
                valid=merge(ct.valid, fresh.valid, True),
                terminal=merge(ct.terminal, fresh.terminal, True),
                root_value0=fresh.root_value0,
            )
            zero = torch.zeros((), device=self.device)
            reused = torch.where(ok, ct.e_visits[:, 0, :].sum(dim=-1), zero)
            base0 = torch.where(ok, carried.base.clamp(min=1), 1).long()
        wasted, base, hist = self._run_waves(batch, tree, wave_rng, base0)
        out = self._output_from_tree(tree, wasted, batch)
        if hist is not None:
            with record_function("search.stats"):
                out.stats = self._stat_pack(tree, wasted, base, hist, batch, reused=reused)
        return out, tree, reused

    @torch.no_grad()
    def promote(self, tree: Tree, actions: torch.Tensor) -> CarriedTree:
        """Compact each game's chosen child's subtree into the leading
        rows (`ops.subtree_promote`). `valid` is False where the chosen
        child was never expanded; callers also clear lanes whose game
        ended or changed hands."""
        cfg = self.config
        with record_function("search.promote"):
            (
                e_visits, e_value, e_reward, children, prior, valid,
                terminal, state_index, promo_valid, retained,
            ) = subtree_promote(
                tree.e_visits, tree.e_value, tree.e_reward, tree.children, tree.prior,
                tree.valid, tree.terminal, actions,
                max_retained=self.reuse_slots, bfs_rounds=cfg.max_depth,
                mode=cfg.tree_reuse_backend,
            )
            bcol = torch.arange(actions.shape[0], device=self.device)[:, None]
            promoted = Tree(
                node_state=tree.node_state.map(lambda x: x[bcol, state_index]),
                e_visits=e_visits,
                e_value=e_value,
                e_reward=e_reward,
                children=children,
                prior=prior,
                valid=valid,
                terminal=terminal,
                # The next `_search_carried` takes the root value afresh.
                root_value0=torch.zeros_like(tree.root_value0),
            )
        return CarriedTree(tree=promoted, valid=promo_valid, base=retained.clamp(min=1).long())

    def zero_carried(self, root_states: EnvState) -> CarriedTree:
        """An all-invalid carry of the right shapes (the start of a
        rollout or of a serving lane); `root_states` only gives shapes."""
        batch = root_states.done.shape[0]
        n, a, dev = self.num_nodes, self.action_dim, self.device

        def zeros():
            return torch.zeros((batch, n, a), dtype=torch.float32, device=dev)

        return CarriedTree(
            tree=Tree(
                node_state=root_states.map(
                    lambda x: x[:, None].expand((batch, n) + tuple(x.shape[1:])).clone()
                ),
                e_visits=zeros(),
                e_value=zeros(),
                e_reward=zeros(),
                children=torch.full((batch, n, a), -1.0, dtype=torch.float32, device=dev),
                prior=zeros(),
                valid=zeros(),
                terminal=torch.zeros((batch, n), dtype=torch.bool, device=dev),
                root_value0=torch.zeros((batch,), dtype=torch.float32, device=dev),
            ),
            valid=torch.zeros((batch,), dtype=torch.bool, device=dev),
            base=torch.ones((batch,), dtype=torch.int64, device=dev),
        )
