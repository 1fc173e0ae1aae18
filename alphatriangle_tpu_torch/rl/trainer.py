"""Learner: counterpart of `alphatriangle_tpu/rl/trainer.py`: LR
schedules, the optimizer chain, the C51 target projection, the loss,
the (fused) train steps and the weight sync, on one device or as one
rank of a dp mesh (`mesh`).

Data parallelism (the JAX learner's dp-sharded batch and replicated
state): each rank steps on its local batch (BATCH_SIZE / dp rows,
`_check_local_batch`), and its gradients are all-reduced and averaged
in one flat bucket (`parallel.sharding.all_reduce_mean_`) before the
optimizer chain, so the clip by global norm sees the global batch's
gradient and every rank applies the same update: the replicas stay bit
for bit equal. With equal local batches the mean of the ranks' loss
means is the global mean; the entropy metric, a ratio of sums, rides
the same bucket as its two sums. A batch norm takes its statistics over
the global batch (`synced_batch_stats`); each rank folds its dp index
into the dropout generator's key, so dp ranks draw different masks. TD
errors come back as the rank's own rows. In a world of one the bucket
still makes its all-reduce (the result is the gradient itself), and
nothing else changes, so the run is the one-process run bit for bit.

Tensor parallelism (the mesh's mdl axis, `tp_size`): the learner's
module holds this rank's shards of the transformer (`nn/model.py`
`tensor_parallel_`, the layout of `parallel.sharding.tp_spec`), and
its Adam moments the same shards. The gradients of replicated
parameters come out whole and equal on the mdl ranks through the
Megatron pair, and those of the shards are the shards of the
replicated learner's, so the bucket averages over the dp line only.
The clip by global norm and the norm metrics see the global norm: the
sharded leaves' squares summed over the mdl line, the replicated
leaves' once. The mdl and sp replicas of a dp row fold the same dp
index into the dropout key and draw the same masks; the sharded MLP's
mask is drawn whole and sliced. Sequence parallelism (the sp axis):
the learner's module takes `attention_fn`
(`parallel/ring_attention.make_sp_attention`), and every sp rank of a
dp row steps on the same rows. `get_state` / `set_state`,
`param_checksum` and `sync_to_network` speak whole tensors (gathered
over mdl; a shard is taken on the way in), so a checkpoint does not
depend on the layout and self-play searches with a whole, dense module.

Outside megastep mode the learner owns a copy of the `NeuralNetwork`'s
module, made at construction (the JAX trainer copies the net's
variables), and self-play searches with the net's own module, which
`sync_to_network` replaces with a fresh copy of the learner's
(`NeuralNetwork.install`) every `WORKER_UPDATE_FREQ_STEPS` steps. In
megastep mode (`FUSED_MEGASTEP`) the learner trains the net's module in
place and the rollout reads it under `torch.no_grad()` in eval mode, so
the weights it searches with are always the learner's newest (zero
staleness, as the JAX megastep's in-program params); there is nothing to
sync. A step switches the learner's module to train mode (transformer
dropout on, masks from a `torch.Generator` seeded by the step's key) and
back to eval mode, and leaves no autograd graph behind.

The host API follows the JAX trainer's: `train_step` (a host batch, one
upload, one fetch), `train_steps` (K steps, one upload and one fetch),
`train_steps_from` (K steps gathered from the device ring at sampled
slots) and their `_begin` / `train_steps_finish` halves, where begin
queues the K steps' work on the card and returns a handle of device
tensors and finish makes the group's one device-to-host copy. The step
counter advances at begin, so the next group's sampling and LR read the
post-group step while the group still runs. With a run's flight recorder
attached (`flight`), begin writes the group's intent (`learner_step`,
`learner_fused_steps` or `learner_fused_from_ring`) before its work is
queued and finish seals it after the fetch: the sealed wall is the
group's dispatch to its results on the host. Each step is a
`learner_step` beacon site, indexed by the step before it, which
launches nothing unless beacons are armed.

The optimizer follows optax's chain as plain tensor functions:
`clip_by_global_norm` (optax's formula, not `clip_grad_norm_`'s
`+1e-6`), then `adamw` = scale_by_adam -> add_decayed_weights (every
parameter, biases and norm scales included, by `WEIGHT_DECAY`; no
torch default leaks in) -> scale by -schedule(count), with the schedule
read at the pre-increment count. `Adam` and `SGD` fold the decay into
the gradient first, as the JAX chains do. Schedules are evaluated on
the host in float32, as optax evaluates them.

`get_state` / `set_state` carry the learner across a checkpoint: the
module's parameters and running statistics (`batch_stats`, empty but
for a batch-norm net), the optimizer's `count`, `mu` and `nu` (keyed by
parameter name), the step and the CPU key, as CPU tensors, which is what
`stats/persistence.py` writes (`nn/convert.py::train_state_from_flax`
builds the same from a JAX learner). `set_state` copies into the
learner's tensors and keeps none of the caller's; a snapshot without
`batch_stats` (written before they were carried) loads into a net that
has none.
"""

import copy
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import rng
from ..config.mesh_config import Mesh, MeshConfig
from ..config.train_config import TrainConfig
from ..parallel.sharding import (
    all_reduce_mean_,
    all_reduce_sum_mdl,
    broadcast_object,
    gather_tensor,
    shard_tensor,
    synced_batch_stats,
)
from ..telemetry.device_stats import emit_beacon
from ..telemetry.roofline import learner_cost, note_program_cost
from ..utils.transfer import fetch, upload
from ..utils.types import DenseBatch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam / adamw defaults


# --- schedule / optimizer ----------------------------------------------


def make_lr_schedule(cfg: TrainConfig):
    """count -> learning rate (float32 arithmetic, returned as float)."""
    f32 = np.float32
    init = f32(cfg.LEARNING_RATE)
    if cfg.LR_SCHEDULER_TYPE == "CosineAnnealingLR":
        t_max = cfg.LR_SCHEDULER_T_MAX or (cfg.MAX_TRAINING_STEPS or 100_000)
        alpha = cfg.LR_SCHEDULER_ETA_MIN / cfg.LEARNING_RATE

        def cosine(count: int) -> float:
            c = f32(min(count, t_max))
            decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(t_max)))
            return float(init * (f32(1 - alpha) * decay + f32(alpha)))

        return cosine
    if cfg.LR_SCHEDULER_TYPE == "StepLR":
        steps, gamma = cfg.LR_SCHEDULER_STEP_SIZE, f32(cfg.LR_SCHEDULER_GAMMA)

        def step_lr(count: int) -> float:
            if count <= 0:
                return float(init)
            return float(init * gamma ** np.floor(f32(count) / f32(steps)))

        return step_lr
    return lambda count: float(init)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element squared."""
    return torch.sqrt(torch.stack([(t * t).sum() for t in tensors]).sum())


@dataclass
class OptState:
    """The optimizer's state: its step count and the Adam moments (one
    tensor per parameter, in `model.parameters()` order)."""

    count: int = 0
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)


class Optimizer:
    """The optax chain of `make_optimizer` (alphatriangle_tpu/rl/trainer.py)."""

    def __init__(self, cfg: TrainConfig, norm=global_norm):
        self.kind = cfg.OPTIMIZER_TYPE
        self.schedule = make_lr_schedule(cfg)
        self.weight_decay = cfg.WEIGHT_DECAY
        self.clip = cfg.GRADIENT_CLIP_VALUE
        # The norm the clip sees (a tensor-parallel learner's is global).
        self.norm = norm

    def init(self, params) -> OptState:
        if self.kind == "SGD":
            return OptState()
        return OptState(
            mu=[torch.zeros_like(p) for p in params], nu=[torch.zeros_like(p) for p in params]
        )

    def update(self, grads, state: OptState, params):
        """(grads, state, params) -> (updates, new state)."""
        if self.clip is not None:
            g_norm = self.norm(grads)
            trigger = g_norm < self.clip
            grads = [torch.where(trigger, g, (g / g_norm) * self.clip) for g in grads]
        wd = self.weight_decay
        if self.kind in ("Adam", "SGD"):
            grads = [g + wd * p for g, p in zip(grads, params)]
        mu, nu = state.mu, state.nu
        if self.kind == "SGD":
            updates = grads
        else:
            mu = [(1 - _B1) * g + _B1 * m for g, m in zip(grads, mu)]
            nu = [(1 - _B2) * (g * g) + _B2 * v for g, v in zip(grads, nu)]
            count_inc = np.float32(state.count + 1)
            bc1 = float(np.float32(1) - np.float32(_B1) ** count_inc)
            bc2 = float(np.float32(1) - np.float32(_B2) ** count_inc)
            updates = [(m / bc1) / (torch.sqrt(v / bc2) + _EPS) for m, v in zip(mu, nu)]
            if self.kind == "AdamW":
                updates = [u + wd * p for u, p in zip(updates, params)]
        step_size = -self.schedule(state.count)
        updates = [step_size * u for u in updates]
        return updates, OptState(count=state.count + 1, mu=mu, nu=nu)


# --- C51 projection -----------------------------------------------------


def project_to_support(
    returns: torch.Tensor, num_atoms: int, v_min: float, v_max: float
) -> torch.Tensor:
    """(B,) scalar returns -> (B, num_atoms) two-hot target distribution."""
    delta_z = (v_max - v_min) / (num_atoms - 1)
    b = (returns.clamp(v_min, v_max) - v_min) / delta_z
    lower = torch.floor(b).long()
    upper = torch.ceil(b).long()
    exact = lower == upper
    w_lower = torch.where(exact, 1.0, upper.to(torch.float32) - b)
    w_upper = torch.where(exact, 0.0, b - lower.to(torch.float32))
    onehot_l = torch.nn.functional.one_hot(lower, num_atoms).to(torch.float32)
    onehot_u = torch.nn.functional.one_hot(upper, num_atoms).to(torch.float32)
    return onehot_l * w_lower[:, None] + onehot_u * w_upper[:, None]


# --- train state / trainer ----------------------------------------------


@dataclass
class TrainState:
    """The learner's host-side state; the parameters are the module's."""

    opt_state: OptState
    step: int  # learner steps taken
    rng: torch.Tensor  # (2,) CPU key: one split per step and per PER draw


def _generator(key: torch.Tensor, device) -> torch.Generator:
    k0, k1 = (int(v) for v in key.tolist())
    return torch.Generator(device=device).manual_seed((k0 << 32) | k1)


class Trainer:
    """Owns the learner state bound to one `NeuralNetwork`."""

    def __init__(self, nn, train_config: TrainConfig, mesh: "Mesh | None" = None, attention_fn=None):
        self.nn = nn
        self.config = train_config
        self.mesh = mesh or MeshConfig.single_device_mesh()
        self.dp_size = self.mesh.dp
        self.tp_size = self.mesh.mdl
        self.model = nn.model if train_config.FUSED_MEGASTEP else copy.deepcopy(nn.model)
        # A dense, whole copy for `sync_to_network` when the learner's
        # module is sharded or sequence-parallel.
        self._whole = None
        if self.tp_size > 1 or attention_fn is not None:
            self._whole = copy.deepcopy(nn.model)
            self._whole.set_attention_fn(None)
        if attention_fn is not None:
            self.model.set_attention_fn(attention_fn)
        self.names = [name for name, _ in self.model.named_parameters()]
        self.full_shapes = {name: tuple(p.shape) for name, p in self.model.named_parameters()}
        from ..nn.model import tensor_parallel_

        layout = tensor_parallel_(self.model, self.mesh)
        # Per parameter: the dim its mdl shards split, or None.
        self.shard_dims = [None if layout[n] == "replicated" else layout[n] for n in self.names]
        if self.dp_size > 1:
            from ..nn.model import BatchNorm

            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.sync_stats = lambda x, dims: synced_batch_stats(x, dims, self.mesh)
        self.device = nn.device
        self.params = list(self.model.parameters())
        for p in self.params:
            p.requires_grad_(True)
        mc = nn.model_config
        self.num_atoms = mc.NUM_VALUE_ATOMS
        self.v_min, self.v_max = mc.VALUE_MIN, mc.VALUE_MAX
        self.optimizer = Optimizer(train_config, norm=self.global_norm)
        self.schedule = self.optimizer.schedule
        self.state = TrainState(
            opt_state=self.optimizer.init(self.params),
            step=0,
            rng=rng.PRNGKey(train_config.RANDOM_SEED),
        )
        # Learner dispatches (one per begun group) and the host seconds
        # spent uploading batches and blocked in the groups' fetches.
        self.dispatch_count = 0
        self.transfer_h2d_seconds = 0.0
        self.transfer_d2h_seconds = 0.0
        # The run's flight recorder; None writes no intent/seal records.
        self.flight = None

    # --- core -------------------------------------------------------------

    def _loss_fn(self, batch: DenseBatch, generator: torch.Generator):
        cfg = self.config
        policy_logits, value_logits = self.model(
            batch["grid"], batch["other_features"], generator=generator
        )
        log_policy = torch.log_softmax(policy_logits, dim=-1)
        pw = batch["policy_weight"]
        policy_ce = pw * -(batch["policy_target"] * log_policy).sum(dim=-1)
        target = project_to_support(batch["value_target"], self.num_atoms, self.v_min, self.v_max)
        value_ce = -(target * torch.log_softmax(value_logits, dim=-1)).sum(dim=-1)
        entropy_rows = -(torch.exp(log_policy) * log_policy).sum(dim=-1)
        entropy_term = (pw * entropy_rows).mean()
        entropy_sum, pw_sum = (pw * entropy_rows).sum(), pw.sum()
        entropy_metric = entropy_sum / pw_sum.clamp(min=1.0)
        w = batch["weights"]
        per_row = cfg.POLICY_LOSS_WEIGHT * policy_ce + cfg.VALUE_LOSS_WEIGHT * value_ce
        # The entropy regulariser is not IS-weighted (as in the reference).
        total = (w * per_row).mean() - cfg.ENTROPY_BONUS_WEIGHT * entropy_term
        aux = {
            "total_loss": total,
            "policy_loss": (w * policy_ce).mean(),
            "value_loss": (w * value_ce).mean(),
            "entropy": entropy_metric,
            "td_errors": value_ce,
            "entropy_sums": (entropy_sum, pw_sum),
        }
        return total, aux

    def _train_step_impl(self, batch: DenseBatch):
        """One SGD step on the module; returns (metrics of 0-d device
        tensors, per-row TD errors (B,))."""
        state = self.state
        keys = rng.split(state.rng)
        drop_key = keys[1] if self.dp_size == 1 else rng.fold_in(keys[1], self.mesh.dp_index)
        self.model.train()
        try:
            with torch.enable_grad():
                total, aux = self._loss_fn(batch, _generator(drop_key, self.device))
                grads = torch.autograd.grad(total, self.params, allow_unused=True)
            # A parameter the loss does not reach has a zero gradient (jax.grad's).
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        finally:
            self.model.eval()
        with torch.no_grad():
            metrics = {
                name: aux[name].detach()
                for name in ("total_loss", "policy_loss", "value_loss", "entropy")
            }
            if self.mesh.backend is not None:
                # Gradients averaged over the ranks; the loss means and the
                # entropy's two sums summed in the same bucket.
                ent_sum, pw_sum = aux["entropy_sums"]
                extra = torch.stack([
                    metrics["total_loss"], metrics["policy_loss"], metrics["value_loss"],
                    ent_sum.detach(), pw_sum.detach(),
                ])
                sums = all_reduce_mean_(grads, self.mesh, extra=extra)
                for i, name in enumerate(("total_loss", "policy_loss", "value_loss")):
                    metrics[name] = sums[i] / self.dp_size
                metrics["entropy"] = sums[3] / sums[4].clamp(min=1.0)
            updates, opt_state = self.optimizer.update(grads, state.opt_state, self.params)
            for p, u in zip(self.params, updates):
                p.add_(u)
            metrics["grad_norm"] = self.global_norm(grads)
            metrics["update_norm"] = self.global_norm(updates)
        self.state = TrainState(opt_state=opt_state, step=state.step + 1, rng=keys[0])
        return metrics, aux["td_errors"].detach()

    def _train_steps_impl(self, stacked: DenseBatch):
        """K steps over the leading axis of `stacked`, in order; returns
        (metrics of (K,) tensors, TD errors (K, B))."""
        k = stacked["value_target"].shape[0]
        outs = []
        for i in range(k):
            emit_beacon("learner_step", self.state.step, device=self.device)
            outs.append(self._train_step_impl({n: v[i] for n, v in stacked.items()}))
        metrics = {name: torch.stack([m[name] for m, _ in outs]) for name in outs[0][0]}
        return metrics, torch.stack([td for _, td in outs])

    @staticmethod
    def _stacked_rows_batch(rows: dict, weights: torch.Tensor) -> DenseBatch:
        """(K, B, ...) ring rows -> the stacked batch; the int8 grid
        casts back to float32 exactly."""
        return {
            "grid": rows["grid"].to(torch.float32),
            "other_features": rows["other_features"],
            "policy_target": rows["policy_target"],
            "value_target": rows["value_target"],
            "policy_weight": rows["policy_weight"],
            "weights": weights,
        }

    def _train_steps_from_impl(self, storage: dict, idx: torch.Tensor, weights: torch.Tensor):
        """K steps whose batches are gathered from the device ring at
        (K, B) slots `idx`."""
        rows = {name: v[idx] for name, v in storage.items()}
        return self._train_steps_impl(self._stacked_rows_batch(rows, weights))

    def global_norm(self, tensors) -> torch.Tensor:
        """optax.global_norm of a per-parameter list over the whole
        model: a sharded leaf's squares summed over the mdl line, a
        replicated leaf's counted once."""
        if self.tp_size == 1:
            return global_norm(tensors)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sharded = sum(((t * t).sum() for t, d in zip(tensors, self.shard_dims) if d is not None), zero)
        whole = sum(((t * t).sum() for t, d in zip(tensors, self.shard_dims) if d is None), zero)
        return torch.sqrt(all_reduce_sum_mdl(sharded, self.mesh) + whole)

    def _full(self, tensors) -> list:
        """A per-parameter list as whole tensors (gathered over mdl)."""
        return [
            t if d is None else gather_tensor(t.detach(), d, self.mesh)
            for t, d in zip(tensors, self.shard_dims)
        ]

    # --- host API ---------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self.state.step

    def get_current_lr(self) -> float:
        """LR at the current step."""
        return float(self.schedule(self.global_step))

    def get_variables(self) -> dict[str, torch.Tensor]:
        """The learner's current weights (its module's live tensors)."""
        return self.model.state_dict()

    def _upload(self, tree):
        t0 = time.perf_counter()
        out = upload(tree, self.device)
        self.transfer_h2d_seconds += time.perf_counter() - t0
        return out

    def _begin(self, run, k: int, program: str, avals: str) -> dict:
        """Queue `run` (K steps on the card) and return its handle; the
        flight span opened here is sealed by `train_steps_finish`."""
        start = self.state.step
        span = self.flight.begin("learner", program, avals=avals) if self.flight is not None else None
        try:
            metrics, td = run()
        except BaseException as exc:  # a failed dispatch seals ok: false
            if span is not None:
                span.seal(error=repr(exc))
            raise
        self.dispatch_count += 1
        return {"k": k, "metrics": metrics, "td": td, "start_step": start, "flight": span}

    def _check_local_batch(self, n: int) -> None:
        """A dp rank's batch is its B / dp share of the global batch:
        equal local batches make the mean of the ranks' means the global
        mean."""
        if self.dp_size > 1 and n * self.dp_size != self.config.BATCH_SIZE:
            raise ValueError(
                f"Local batch size {n} is not BATCH_SIZE={self.config.BATCH_SIZE} over "
                f"dp={self.dp_size}."
            )

    def broadcast_state(self) -> None:
        """Rank 0's learner state (parameters, running statistics, Adam
        moments, step, key) on every rank: the replicas start equal at
        setup (a restore installs rank 0's broadcast snapshot on every
        rank, `training/runner.py`). The state travels whole and each
        rank takes its shards."""
        if self.mesh.backend is None:
            return
        self.set_state(broadcast_object(self.get_state(), self.mesh))

    def param_checksum(self) -> tuple:
        """An exact digest of the whole parameters' bits (gathered over
        mdl; every rank calls it): the int64 sums of their float32
        words, plain and weighted by position mod 1021. Replicas whose
        bits agree give equal digests."""
        with torch.no_grad():
            words = torch.cat([p.reshape(-1).view(torch.int32) for p in self._full(self.params)])
            words = words.to(torch.int64)
            weight = torch.arange(words.numel(), device=words.device) % 1021 + 1
            return int(words.sum()), int((words * weight).sum())

    def train_step(self, batch: dict):
        """One step on a host batch. Returns (metrics, per-sample TD
        errors), or None on an empty batch."""
        if int(batch["value_target"].shape[0]) == 0:
            return None
        return self.train_steps_finish(self.train_steps_begin([batch]))[0]

    def train_steps(self, batches: list) -> list:
        """K steps on host batches, one upload and one fetch; the
        per-step (metrics, TD errors) list, in order."""
        handle = self.train_steps_begin(batches)
        return [] if handle is None else self.train_steps_finish(handle)

    def train_steps_begin(self, batches: list) -> "dict | None":
        """Upload K host batches at once and queue their steps; None when
        there is no batch or it is empty."""
        if not batches:
            return None
        n = int(batches[0]["value_target"].shape[0])
        if n == 0:
            return None
        self._check_local_batch(n)
        batches = [
            {"policy_weight": np.ones(n, dtype=np.float32), **b} for b in batches
        ]
        stacked = self._upload(
            {key: np.stack([np.asarray(b[key]) for b in batches]) for key in batches[0]}
        )
        k = len(batches)
        if k == 1:
            program, avals = "learner_step", f"B{n}"
        else:
            program, avals = "learner_fused_steps", f"K{k}xB{n}"
        note_program_cost(
            program,
            lambda: learner_cost(self, k, n, sum(int(np.asarray(v[0]).nbytes) for v in batches[0].values())),
            avals, self.device.type,
        )
        return self._begin(lambda: self._train_steps_impl(stacked), k, program, avals)

    def train_steps_from(self, buffer, samples: list) -> list:
        """K steps on rows the device ring holds at the sampled slots."""
        handle = self.train_steps_from_begin(buffer, samples)
        return [] if handle is None else self.train_steps_finish(handle)

    def train_steps_from_begin(self, buffer, samples: list) -> "dict | None":
        """Upload the K samples' (B,) slots and IS weights and queue the
        K steps, gathering their rows from `buffer.storage` on the card."""
        if not samples:
            return None
        dev = self._upload({
            "idx": np.stack([np.asarray(s["indices"], dtype=np.int64) for s in samples]),
            "weights": np.stack([np.asarray(s["weights"], dtype=np.float32) for s in samples]),
        })
        k, n = len(samples), len(samples[0]["indices"])
        # A row gathered from the ring: its stored bytes (the grid int8).
        note_program_cost(
            "learner_fused_from_ring",
            lambda: learner_cost(self, k, n, sum(int(t[0].nbytes) for t in buffer.storage.values())),
            f"K{k}xB{n}", self.device.type,
        )
        return self._begin(
            lambda: self._train_steps_from_impl(buffer.storage, dev["idx"], dev["weights"]),
            k, "learner_fused_from_ring", f"K{k}",
        )

    def train_steps_finish(self, handle: dict) -> list:
        """The group's one device-to-host copy; the per-step (metrics with
        the step's LR, TD errors) list, in order."""
        span = handle.pop("flight", None)
        t0 = time.perf_counter()
        try:
            host = fetch({"metrics": handle["metrics"], "td": handle["td"]})
        except BaseException as exc:
            if span is not None:
                span.seal(error=repr(exc))
            raise
        self.transfer_d2h_seconds += time.perf_counter() - t0
        if span is not None:
            span.seal()
        results = []
        for i in range(handle["k"]):
            m = {key: float(v[i]) for key, v in host["metrics"].items()}
            m["learning_rate"] = float(self.schedule(handle["start_step"] + i + 1))
            results.append((m, host["td"][i]))
        return results

    def _stats_buffers(self) -> dict:
        """The module's running statistics by name (batch norms only)."""
        return {
            n: b for n, b in self.model.named_buffers()
            if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")
        }

    def get_state(self) -> dict:
        """The learner's state as CPU copies (nothing aliases the live
        tensors, which the next step updates in place): {"params",
        "batch_stats", "opt_state": {"count", "mu", "nu"}, "step",
        "rng"}, the tensors keyed by parameter or buffer name, whole
        (gathered over mdl: every rank calls it)."""
        names = self.names
        opt = self.state.opt_state

        def host(tensors) -> dict:
            return {n: t.detach().cpu().clone() for n, t in zip(names, self._full(tensors))}

        return {
            "params": host(self.params),
            "batch_stats": {n: t.detach().cpu().clone() for n, t in self._stats_buffers().items()},
            "opt_state": {"count": int(opt.count), "mu": host(opt.mu), "nu": host(opt.nu)},
            "step": int(self.state.step),
            "rng": self.state.rng.detach().cpu().clone(),
        }

    def set_state(self, state: dict) -> None:
        """Install a `get_state` snapshot (whole tensors): the
        parameters and running statistics are copied into the module in
        place (the net's own in megastep mode; otherwise
        `sync_to_network` hands them to self-play), the moments into
        fresh tensors on the learner's device; a tensor-parallel rank
        takes its shards. Raises when a name or a shape differs from
        this learner's."""
        names = self.names
        buffers = self._stats_buffers()
        opt = state["opt_state"]
        stats = state.get("batch_stats", {})
        shapes = self.full_shapes
        for part, tree, want in (
            ("params", state["params"], shapes),
            ("batch_stats", stats, {n: tuple(b.shape) for n, b in buffers.items()}),
            ("mu", opt["mu"], shapes),
            ("nu", opt["nu"], shapes),
        ):
            if part in ("mu", "nu") and not tree and self.optimizer.kind == "SGD":
                continue
            if set(tree) != set(want):
                raise ValueError(
                    f"{part} names differ from the learner's: "
                    f"{sorted(set(tree) ^ set(want))[:4]}"
                )
            for name, shape in want.items():
                if tuple(tree[name].shape) != shape:
                    raise ValueError(
                        f"{part}[{name}] has shape {tuple(tree[name].shape)}, "
                        f"the learner's {shape}"
                    )

        def local(tree) -> list:
            return [
                tree[n] if d is None else shard_tensor(tree[n], d, self.mesh)
                for n, d in zip(names, self.shard_dims)
            ]

        def device(tree) -> list:
            if not tree:
                return []
            return [t.to(self.device, p.dtype, copy=True) for t, p in zip(local(tree), self.params)]

        with torch.no_grad():
            for p, t in zip(self.params, local(state["params"])):
                p.copy_(t)
            for name, b in buffers.items():
                b.copy_(stats[name])
        self.state = TrainState(
            opt_state=OptState(count=int(opt["count"]), mu=device(opt["mu"]), nu=device(opt["nu"])),
            step=int(state["step"]),
            rng=torch.as_tensor(state["rng"], dtype=torch.int64).clone().cpu(),
        )

    def sync_to_network(self) -> int:
        """Install a device-side copy of the learner's module (its
        running statistics included; whole and dense) as the net's
        weights; returns the bumped weights version. Chunks that already
        read the net's weights keep theirs."""
        if self.model is self.nn.model:
            raise RuntimeError(
                "the learner trains the net's own module (megastep mode): there is nothing to sync"
            )
        if self._whole is None:
            return self.nn.install(copy.deepcopy(self.model))
        # Whole tensors (gathered over mdl: every rank calls it) in a
        # dense copy of the net's module.
        model = copy.deepcopy(self._whole)
        with torch.no_grad():
            for p, t in zip(model.parameters(), self._full(self.params)):
                p.copy_(t)
            whole = dict(model.named_buffers())
            for name, b in self._stats_buffers().items():
                whole[name].copy_(b)
        return self.nn.install(model)
