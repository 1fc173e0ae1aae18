"""The autotuner's search space: counterpart of
`alphatriangle_tpu/autotune/space.py`.

A candidate is one point of the `(SELF_PLAY_BATCH_SIZE,
BUFFER_CAPACITY, rollout chunk T, fused K, dp, geometry)` space, with
the kernel axes beside it. Everything here is config arithmetic, so
enumeration and the gates run at once and need no card.

Two prunes run before the feasibility oracle:

- **Divisibility gates** mirror `sharded_megastep_dp`
  (telemetry/memory.py) and the training setup's buffer gate: a
  dp-sharded candidate whose capacity, learner batch or lane count does
  not divide dp would run the single-device megastep, so the search
  never scores it as a dp candidate.
- **Monotone-in-B dominance**: with every other axis fixed, the budget
  and the predicted throughput both grow with the lane count B, so
  within a group only the largest feasible B can win. The search walks
  B descending and marks the rest dominated without asking the oracle.

The kernel axes keep the JAX mode strings and `oracle_key()` keeps the
JAX axes, so the search's rows and oracle counts equal the reference's.
On a CUDA tensor every mode string launches the same hand-written
kernel (ROADMAP, *Kernels*): on the card `descent_gather="einsum"`
measures what the other gathers do, and its oracle answer is theirs.
"""

from dataclasses import dataclass, field

# Row statuses the search assigns to candidates (the table and the JSON).
STATUS_FIT = "fit"  # the oracle says it fits
STATUS_OVER = "over"  # the oracle says it is over the byte limit
STATUS_GATE = "gate"  # failed a divisibility / geometry gate
STATUS_DOMINATED = "dominated"  # smaller B than a feasible sibling
STATUS_RING = "ring-over"  # the ring alone exceeds the limit
STATUS_SKIPPED = "skipped"  # the search ended before evaluating it


@dataclass(frozen=True)
class Candidate:
    """One point of the search space. The kernel axes choose lowerings
    of the same arithmetic and the rollout's inference precision; only
    `descent_gather`, `inference_precision` and `tree_reuse` are in
    `oracle_key()`, as in the reference."""

    geometry: str  # named board geometry (config/presets.py) or "plan"
    sp_batch: int  # SELF_PLAY_BATCH_SIZE (lockstep lanes)
    capacity: int  # BUFFER_CAPACITY (replay ring rows)
    chunk: int  # ROLLOUT_CHUNK_MOVES (T)
    fused_k: int  # FUSED_LEARNER_STEPS (K)
    dp: int  # data-parallel width tuned for
    descent_gather: str = "einsum"  # MCTSConfig.descent_gather
    backup_update: str = "xla"  # MCTSConfig.backup_update
    per_sample: str = "xla"  # TrainConfig.PER_SAMPLE_BACKEND
    inference_precision: str = "float32"  # ModelConfig.INFERENCE_PRECISION
    # Serve-shape ladder (serving/buckets.py): CSV rungs, "" = one rung at
    # the plan's serve batch. A serve-side axis, absent from oracle_key().
    serve_buckets: str = ""
    # MCTSConfig.tree_reuse: widens every tree plane, so it is in oracle_key().
    tree_reuse: bool = False

    def group_key(self) -> tuple:
        """Axes held fixed under monotone-in-B dominance."""
        return (
            self.geometry, self.capacity, self.chunk, self.fused_k, self.dp,
            self.descent_gather, self.backup_update, self.per_sample,
            self.inference_precision, self.serve_buckets, self.tree_reuse,
        )

    def oracle_key(self) -> tuple:
        """Axes the oracle's answer can depend on; candidates that differ
        only in `backup_update`, `per_sample` or `serve_buckets` share one
        answer."""
        return (
            self.geometry, self.sp_batch, self.capacity, self.chunk, self.fused_k, self.dp,
            self.descent_gather, self.inference_precision, self.tree_reuse,
        )

    def kernels(self) -> dict:
        """The kernel-axis block (the tuned preset's provenance)."""
        return {
            "descent_gather": self.descent_gather,
            "backup_update": self.backup_update,
            "per_sample": self.per_sample,
            "inference_precision": self.inference_precision,
            "serve_buckets": self.serve_buckets,
            "tree_reuse": self.tree_reuse,
        }

    def label(self) -> str:
        base = (
            f"{self.geometry}/B{self.sp_batch}/cap{self.capacity}"
            f"/t{self.chunk}/k{self.fused_k}/dp{self.dp}"
        )
        tags = [
            tag
            for tag, default in (
                (f"g-{self.descent_gather}", "g-einsum"),
                (f"b-{self.backup_update}", "b-xla"),
                (f"s-{self.per_sample}", "s-xla"),
                (f"p-{self.inference_precision}", "p-float32"),
                (f"sb-{self.serve_buckets}", "sb-"),
                (f"r-{'on' if self.tree_reuse else 'off'}", "r-off"),
            )
            if tag != default
        ]
        return base + (f"/{'+'.join(tags)}" if tags else "")


def _ints(values) -> list:
    return sorted({int(v) for v in values})


@dataclass
class SearchSpace:
    """Axis values the tuner enumerates; a geometry is a name of
    `config.presets.GEOMETRY_PRESETS` or "plan" (the plan's own board)."""

    geometries: list = field(default_factory=lambda: ["plan"])
    batches: list = field(default_factory=lambda: [256, 512, 1024])
    capacities: list = field(default_factory=lambda: [50_000, 100_000])
    chunks: list = field(default_factory=lambda: [8, 16])
    fused_ks: list = field(default_factory=lambda: [8, 16])
    dps: list = field(default_factory=lambda: [1])
    # Kernel axes: one value each unless a caller asks for more.
    descent_gathers: list = field(default_factory=lambda: ["einsum"])
    backup_updates: list = field(default_factory=lambda: ["xla"])
    per_samples: list = field(default_factory=lambda: ["xla"])
    precisions: list = field(default_factory=lambda: ["float32"])
    serve_bucket_ladders: list = field(default_factory=lambda: [""])
    tree_reuses: list = field(default_factory=lambda: [False])

    def candidates(self) -> list:
        """Every lattice point, B descending within each group so the
        dominance walk stops at the first feasible lane count."""
        kernel_points = [
            (g, bu, ps, pr, sb, tr)
            for g in self.descent_gathers
            for bu in self.backup_updates
            for ps in self.per_samples
            for pr in self.precisions
            for sb in self.serve_bucket_ladders
            for tr in self.tree_reuses
        ]
        out = []
        for geometry in self.geometries:
            for capacity in _ints(self.capacities):
                for chunk in _ints(self.chunks):
                    for k in _ints(self.fused_ks):
                        for dp in _ints(self.dps):
                            for gather, backup, sample, prec, buckets, reuse in kernel_points:
                                for b in sorted({int(b) for b in self.batches}, reverse=True):
                                    out.append(Candidate(
                                        geometry=geometry, sp_batch=b, capacity=capacity,
                                        chunk=chunk, fused_k=k, dp=dp, descent_gather=gather,
                                        backup_update=backup, per_sample=sample,
                                        inference_precision=prec, serve_buckets=buckets,
                                        tree_reuse=reuse,
                                    ))
        return out

    def size(self) -> int:
        n = len(self.geometries)
        for axis in (self.batches, self.capacities, self.chunks, self.fused_ks, self.dps):
            n *= len({int(v) for v in axis})
        for axis in (self.descent_gathers, self.backup_updates, self.per_samples,
                     self.precisions, self.serve_bucket_ladders, self.tree_reuses):
            n *= len(axis)
        return n


def divisibility_gate(candidate: Candidate, lbatch: int, min_buffer: int) -> "str | None":
    """The reason a candidate fails a hard config gate, else None: the
    TrainConfig validators and `sharded_megastep_dp`, so gated candidates
    are the ones a run would refuse or run unsharded."""
    c = candidate
    if c.sp_batch < 1 or c.capacity < 1 or c.chunk < 1 or c.fused_k < 1:
        return "non-positive axis"
    if lbatch > c.capacity:
        return f"BATCH_SIZE {lbatch} > BUFFER_CAPACITY {c.capacity}"
    if min_buffer > c.capacity:
        return f"MIN_BUFFER_SIZE_TO_TRAIN {min_buffer} > BUFFER_CAPACITY {c.capacity}"
    if c.dp > 1:
        for name, value in (
            ("BUFFER_CAPACITY", c.capacity),
            ("BATCH_SIZE", lbatch),
            ("SELF_PLAY_BATCH_SIZE", c.sp_batch),
        ):
            if value % c.dp != 0:
                return f"{name} {value} % dp {c.dp} != 0"
    return None


def prune_dominated(candidates: list, feasible: set) -> dict:
    """{candidate: STATUS_DOMINATED} for every candidate whose group holds
    a feasible sibling (in `feasible`) of a larger B."""
    best_b: dict = {}
    for c in feasible:
        key = c.group_key()
        if key not in best_b or c.sp_batch > best_b[key]:
            best_b[key] = c.sp_batch
    out = {}
    for c in candidates:
        top = best_b.get(c.group_key())
        if top is not None and c.sp_batch < top:
            out[c] = STATUS_DOMINATED
    return out
