"""Gumbel root search with sequential halving: counterpart of
`alphatriangle_tpu/mcts/gumbel.py` (`GumbelMCTS`).

The root action comes from the procedure of "Policy improvement by
planning with Gumbel" (Danihelka et al., ICLR 2022) on top of the
wave-parallel search:

- Gumbel noise on the root's prior logits picks the candidates: the
  `min(gumbel_m, W, A)` highest `g + logits` valid actions (every
  action tied with the last of them too). Dirichlet root noise is off.
- Each wave spreads its W members over the surviving candidates (a
  forced depth-0 action per member, `BatchedMCTS._descend_wave`), and
  after every wave but the last the candidates are halved by
  `g + logits + sigma(q)`: the waves are the halving phases.
- The played action (`selected_action`) is the argmax of the final
  candidates' scores, -1 on finished games; the policy target is the
  completed-Q improved policy `softmax(logits + sigma(q_completed))`
  over the valid actions, unvisited actions taking the root's network
  value.

sigma(q) = (c_visit + max_a N(a)) * c_scale * q. `exploit=True` zeroes
the Gumbel sample (playout-cap fast searches, serving and evaluation
play the best cheap move). The JAX version's `fori_loop` over waves
with a `lax.cond` before the halving is a plain Python loop here; the
Gumbel draw goes through `rng.gumbel`, looked up at call time so tests
can substitute JAX's draws. The waves carry the depth histogram and
reach the `search_wave` beacon site, and the output the stat-pack, as
`BatchedMCTS`'s do.
"""

import torch
from torch.profiler import record_function

from .. import rng
from . import helpers
from ..config.mcts_config import MCTSConfig
from .search import BatchedMCTS, SearchOutput, Tree


class GumbelMCTS(BatchedMCTS):
    """Wave-parallel search with a Gumbel sequential-halving root."""

    def __init__(
        self,
        env,
        extractor,
        model,
        config: MCTSConfig,
        value_support: torch.Tensor,
        exploit: bool = False,
    ):
        super().__init__(
            env, extractor, model, config.model_copy(update={"dirichlet_epsilon": 0.0}), value_support
        )
        self.m_candidates = config.gumbel_m
        self.c_visit = config.gumbel_c_visit
        self.c_scale = config.gumbel_c_scale
        self.exploit = exploit

    def _sigma(self, q: torch.Tensor, visits: torch.Tensor) -> torch.Tensor:
        """Monotone Q transform: (c_visit + max N) * c_scale * q."""
        max_n = visits.amax(dim=-1, keepdim=True)
        return (self.c_visit + max_n) * self.c_scale * q

    @staticmethod
    def _root_q(tree: Tree) -> tuple[torch.Tensor, torch.Tensor]:
        """(q, visits) of the root edges, (B, A) each."""
        visits = tree.e_visits[:, 0, :]
        q = torch.where(visits > 0, tree.e_value[:, 0, :] / visits.clamp(min=1e-9), 0.0)
        return q, visits

    def _assign_roots(self, tree: Tree, cand: torch.Tensor) -> torch.Tensor:
        """(B, A) candidate mask -> (B, W) forced root actions. The first
        `count` members cover every candidate once; surplus members
        repeat the cycle only onto candidates already expanded, and one
        aimed at a still-unexpanded edge is released to PUCT (-1), since
        it would duplicate the first member's expansion."""
        w = self.wave_size
        order = torch.argsort((~cand).to(torch.uint8), dim=-1, stable=True)
        count = cand.sum(dim=-1, keepdim=True).clamp(min=1)
        j = torch.arange(w, device=self.device)[None, :]
        roots = order.gather(1, j % count)
        expanded = tree.children[:, 0, :].gather(1, roots) >= 0
        return torch.where((j < count) | expanded, roots, -1)

    def _halve(self, tree: Tree, cand: torch.Tensor, base_score: torch.Tensor) -> torch.Tensor:
        """Keep the better ceil(count / 2) candidates (at least one) by
        g + logits + sigma(q); ties with the last one kept stay too."""
        q, visits = self._root_q(tree)
        score = torch.where(cand, base_score + self._sigma(q, visits), float("-inf"))
        keep = ((cand.sum(dim=-1) + 1) // 2).clamp(min=1)
        ascending = torch.sort(score, dim=-1).values
        kth = ascending.gather(1, (self.action_dim - keep)[:, None])
        return cand & (score >= kth)

    def root_actions(self, output: SearchOutput) -> torch.Tensor:
        """The played action of each root: the search's own
        `selected_action`, not the visit argmax."""
        return helpers.root_actions(output, use_gumbel=True)

    @torch.no_grad()
    def search(self, root_states, key: torch.Tensor) -> SearchOutput:
        """`max_simulations` simulations in `num_waves` halving phases from
        `root_states`; `key` is one (2,) key on the CPU."""
        batch = root_states.done.shape[0]
        a, dev = self.action_dim, self.device
        keys = rng.split(key, 4)
        init_rng, gumbel_rng, wave_rng = keys[1], keys[2], keys[3]
        with record_function("search.init_tree"):
            tree = self._init_tree(root_states, init_rng)
            valid = tree.valid[:, 0, :] > 0
            logits = torch.where(valid, torch.log(tree.prior[:, 0, :].clamp(min=1e-12)), float("-inf"))
            if self.exploit:
                g = torch.zeros((batch, a), device=dev)
            else:
                g = rng.gumbel(gumbel_rng, (batch, a), device=dev, lanes=self.lanes)
            base_score = torch.where(valid, g + logits, float("-inf"))
            # m is clamped to the wave so every survivor gets at least one
            # simulation per halving phase.
            m0 = min(self.m_candidates, self.wave_size, a)
            kth = torch.sort(base_score, dim=-1).values[:, -m0][:, None]
            cand = valid & (base_score >= kth)

        wasted = torch.zeros((batch,), dtype=torch.int32, device=dev)
        base = 1
        hist = self._stats_seed()
        for k in range(self.num_waves):
            self.beacon(k)
            roots = self._assign_roots(tree, cand)
            wasted, base = self._wave(
                batch, tree, wasted, base, rng.fold_in(wave_rng, k), roots, hist=hist
            )
            if k < self.num_waves - 1:
                cand = self._halve(tree, cand, base_score)

        q, visits = self._root_q(tree)
        final = torch.where(cand, base_score + self._sigma(q, visits), float("-inf"))
        selected = torch.argmax(final, dim=-1).to(torch.int32)
        selected = torch.where(root_states.done, -1, selected)

        # Completed-Q improved policy: unvisited actions take the root's
        # network value.
        q_completed = torch.where(visits > 0, q, tree.root_value0[:, None])
        improved_logits = torch.where(valid, logits + self._sigma(q_completed, visits), float("-inf"))
        any_valid = valid.any(dim=-1, keepdim=True)
        improved = torch.softmax(torch.where(any_valid, improved_logits, 0.0), dim=-1)
        improved = torch.where(valid, improved, 0.0)
        improved = improved / improved.sum(dim=-1, keepdim=True).clamp(min=1e-9)

        root_visits = 1.0 + visits.sum(dim=-1)
        root_value = (tree.root_value0 + tree.e_value[:, 0, :].sum(dim=-1)) / root_visits
        stats = None
        if hist is not None:
            with record_function("search.stats"):
                stats = self._stat_pack(tree, wasted, base, hist, batch)
        return SearchOutput(
            visit_counts=visits.clone(),
            root_value=root_value,
            root_prior=tree.prior[:, 0].clone(),
            total_simulations=self.config.max_simulations * batch,
            wasted_slots=wasted,
            selected_action=selected,
            improved_policy=improved,
            stats=stats,
        )
