"""The serve-shape bucket ladder: counterpart of
`alphatriangle_tpu/serving/buckets.py` (`default_rungs`, `BucketLadder`),
copied so the port imports nothing of the JAX package.

A ladder is the sorted set of slot counts a `PolicyService` may
dispatch at. The service's micro-batcher walks up one rung under
sustained fill (or at once when an admission would not fit) and down
one on a drain; `cli serve --buckets` warms every rung before the load.
Stdlib only.
"""

from dataclasses import dataclass


def default_rungs(base: int, *, floor: int = 1) -> tuple[int, ...]:
    """The implicit ladder under a single `--slots` knob: geometric
    halving from `base` down to `floor`."""
    base = int(base)
    if base < 1:
        raise ValueError(f"ladder base must be >= 1, got {base}")
    rungs = []
    r = base
    while r > max(1, int(floor)):
        rungs.append(r)
        r = max(1, r // 2)
    rungs.append(max(1, int(floor)) if base >= floor else base)
    return tuple(sorted(set(rungs)))


@dataclass(frozen=True)
class BucketLadder:
    """Sorted, deduplicated serve batch shapes (e.g. (64, 256, 1024)).
    Walking up or down moves one index; every lookup clamps to a rung
    the ladder owns."""

    rungs: tuple[int, ...]

    def __post_init__(self):
        rungs = tuple(sorted({int(r) for r in self.rungs}))
        if not rungs:
            raise ValueError("BucketLadder needs at least one rung")
        if rungs[0] < 1:
            raise ValueError(f"rungs must be >= 1, got {rungs}")
        object.__setattr__(self, "rungs", rungs)

    # --- construction -------------------------------------------------

    @classmethod
    def from_spec(cls, spec, base: "int | None" = None) -> "BucketLadder":
        """A ladder from an iterable of ints, a CSV string ("64,256,1024";
        ";" also separates), or None / "" (the halving ladder under
        `base`). A `base` outside the spec becomes a rung."""
        if isinstance(spec, BucketLadder):
            return spec
        if spec is None or spec == "":
            if base is None:
                raise ValueError("from_spec needs a spec or a base")
            return cls(default_rungs(base))
        if isinstance(spec, str):
            spec = [p for p in spec.replace(";", ",").split(",") if p.strip()]
        rungs = tuple(int(p) for p in spec)
        if base is not None and int(base) not in rungs:
            rungs = rungs + (int(base),)
        return cls(rungs)

    @classmethod
    def single(cls, slots: int) -> "BucketLadder":
        """The one-rung ladder: fixed-shape serving."""
        return cls((int(slots),))

    # --- lookups ------------------------------------------------------

    @property
    def min_rung(self) -> int:
        return self.rungs[0]

    @property
    def max_rung(self) -> int:
        return self.rungs[-1]

    def __contains__(self, rung) -> bool:
        return int(rung) in self.rungs

    def index(self, rung: int) -> int:
        return self.rungs.index(int(rung))

    def rung_for(self, demand: int) -> int:
        """Smallest rung holding `demand` sessions (the top rung when
        demand exceeds every shape)."""
        for r in self.rungs:
            if r >= demand:
                return r
        return self.max_rung

    def rung_at_or_below(self, target: float) -> int:
        """Largest rung <= target (the bottom rung when none is)."""
        best = self.rungs[0]
        for r in self.rungs:
            if r <= target:
                best = r
        return best

    def up(self, rung: int) -> int:
        """One rung up (clamped at the top)."""
        return self.rungs[min(self.index(rung) + 1, len(self.rungs) - 1)]

    def down(self, rung: int) -> int:
        """One rung down (clamped at the bottom)."""
        return self.rungs[max(self.index(rung) - 1, 0)]

    def walk_down(self, rung: int, strikes: int = 1) -> int:
        """`strikes` forced steps down."""
        r = int(rung)
        for _ in range(max(0, int(strikes))):
            r = self.down(r)
        return r
