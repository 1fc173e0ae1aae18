"""Verdict-driven recovery policy: counterpart of
`alphatriangle_tpu/supervise/policy.py`.

`RecoveryPolicy.decide` maps one child death (a `classify_run` verdict,
its exit code, its program family and its progress) to one `Action`:
restart after a backoff with accumulated overrides, or give up. All
state (backoff streak, restart budget, per-family wedge counts, the OOM
ladder) lives here, with an injectable clock, so tests drive the whole
matrix without a process.

    wedge (113 / dispatch-hung / compile-hung)
        restart with exponential backoff; the `quarantine_after`-th
        wedge on one program family applies that family's quarantine
        override (serve: respawn onto the ladder's lower rung,
        `SERVE_SLOTS__scale = 0.5`, read by serving/fleet.py)
    oom             restart with SELF_PLAY_BATCH_SIZE scaled down
    preempted (114) restart at the base delay; resets the streak
    anything else   restart with exponential backoff

    circuit breaker: consecutive deaths without progress, or deaths past
    the restart budget, -> give up.

A wedge also records `TELEMETRY__BEACONS` in the overrides, as the JAX
policy does; the port's replicas have no beacons yet and ignore it.
Stdlib only.
"""

import time
from dataclasses import dataclass, field

from ..telemetry.flight import (  # noqa: F401  (re-exported for callers)
    PREEMPT_EXIT_CODE,
    SUPERVISOR_GIVEUP_EXIT_CODE,
    WEDGE_EXIT_CODE,
)

#: Verdicts that mean "a device program hung" — the family counts
#: toward quarantine.
WEDGE_VERDICTS = ("dispatch-hung", "compile-hung")

#: program family -> the override that removes that family's riskiest
#: moving part. Applied after `quarantine_after` wedges on the family.
QUARANTINE_OVERRIDES: dict[str, dict] = {
    "megastep": {"FUSED_MEGASTEP": False},
    "learner": {"FUSED_LEARNER_STEPS": 1},
    "rollout": {"ASYNC_ROLLOUTS": False},
    # Serve replicas: halve the serve width. Interpreted by the fleet
    # supervisor (serving/fleet.py maps it onto the replica's --slots
    # argv, snapped down onto the ladder), not by TrainConfig.
    "serve": {"SERVE_SLOTS__scale": 0.5},
}


@dataclass
class Action:
    """One recovery decision for one child death."""

    kind: str  # "restart" | "give-up"
    delay_s: float = 0.0
    overrides: dict = field(default_factory=dict)
    reason: str = ""


class RecoveryPolicy:
    """Stateful verdict->action mapper. One instance per supervised
    run; `clock` is injectable so tests freeze time."""

    def __init__(
        self,
        *,
        max_restarts: int = 8,
        circuit_breaker_deaths: int = 3,
        backoff_base_s: float = 5.0,
        backoff_max_s: float = 300.0,
        quarantine_after: int = 2,
        oom_scale: float = 0.5,
        clock=time.monotonic,
    ) -> None:
        self.max_restarts = max_restarts
        self.circuit_breaker_deaths = circuit_breaker_deaths
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.quarantine_after = quarantine_after
        self.oom_scale = oom_scale
        self._clock = clock
        self.deaths = 0
        self.streak = 0  # consecutive deaths without checkpoint progress
        self._last_progress: "int | None" = None
        self._family_wedges: dict[str, int] = {}
        self._oom_count = 0
        self._overrides: dict = {}
        self.history: list[dict] = []

    def decide(
        self,
        verdict: str,
        exit_code: int,
        family: "str | None" = None,
        progress_step: "int | None" = None,
    ) -> Action:
        """Record one child death and return the recovery action.

        `progress_step` is the newest COMMITTED checkpoint step in the
        run dir — forward motion between deaths is what resets the
        backoff streak and holds the circuit breaker open.
        """
        self.deaths += 1
        progressed = progress_step is not None and (
            self._last_progress is None or progress_step > self._last_progress
        )
        preempted = verdict == "preempted" or exit_code == PREEMPT_EXIT_CODE
        if progressed or preempted:
            self.streak = 1
        else:
            self.streak += 1
        if progress_step is not None:
            self._last_progress = progress_step
        self.history.append(
            {
                "t": self._clock(),
                "verdict": verdict,
                "exit_code": exit_code,
                "family": family,
                "progress_step": progress_step,
            }
        )

        if self.deaths > self.max_restarts:
            return Action(
                kind="give-up",
                reason=f"restart budget exhausted ({self.deaths - 1} "
                f"restarts > {self.max_restarts})",
            )
        if self.streak > self.circuit_breaker_deaths:
            return Action(
                kind="give-up",
                reason=f"circuit breaker: {self.streak} consecutive "
                "deaths without a new committed checkpoint",
            )

        reasons: list[str] = []
        wedged = verdict in WEDGE_VERDICTS or exit_code == WEDGE_EXIT_CODE
        if wedged:
            # The JAX policy's directive to build the respawn's
            # programs with progress beacons; kept so both policies
            # ledger the same overrides.
            if not self._overrides.get("TELEMETRY__BEACONS"):
                self._overrides["TELEMETRY__BEACONS"] = True
                reasons.append(
                    "arming progress beacons for the respawn (a repeat "
                    "wedge will name its phase)"
                )
        if wedged and family:
            count = self._family_wedges.get(family, 0) + 1
            self._family_wedges[family] = count
            if count >= self.quarantine_after:
                quarantine = QUARANTINE_OVERRIDES.get(family)
                if quarantine:
                    self._overrides.update(quarantine)
                    reasons.append(
                        f"quarantined family '{family}' after {count} "
                        f"wedges ({quarantine})"
                    )
        if verdict == "oom":
            self._oom_count += 1
            scale = self.oom_scale**self._oom_count
            self._overrides["SELF_PLAY_BATCH_SIZE__scale"] = scale
            reasons.append(
                f"oom #{self._oom_count}: scaling SELF_PLAY_BATCH_SIZE "
                f"by {scale:g}"
            )
            if self._oom_count >= 2:
                self._overrides["FUSED_LEARNER_STEPS"] = 1
                reasons.append("oom repeat: forcing FUSED_LEARNER_STEPS=1")

        delay = min(
            self.backoff_max_s,
            self.backoff_base_s * 2 ** (self.streak - 1),
        )
        reasons.append(
            f"backoff {delay:g}s (streak {self.streak}, "
            f"death {self.deaths}/{self.max_restarts})"
        )
        return Action(
            kind="restart",
            delay_s=delay,
            overrides=dict(self._overrides),
            reason="; ".join(reasons),
        )
