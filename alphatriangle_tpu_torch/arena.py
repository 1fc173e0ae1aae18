"""Arena play for strength evaluation: counterpart of
`alphatriangle_tpu/arena.py` (`play`, `play_service`,
`greedy_mcts_policy`), the core of `cli eval`.

Paired hands: reset keys are fixed by `seed`, and the engine's shape
draws depend only on the step index (its key chain splits every step
whatever the action), so game i sees the same hands under every policy
and a comparison of two policies is paired, free of the hand luck that
dominates this game.

Arena play is a client of the serving session API: games are admitted
into a `SessionSlots` array and stepped through the masked lockstep
path the policy service dispatches. `play` drives any
`policy_fn(states, move) -> (B,) actions` over the slot states;
`play_service` drives the paired games through `PolicyService`'s
request queue and dispatch, with `greedy_mcts_policy`'s keys, and gives
the same games: a session plays the same game whatever the other lanes
hold (serving/session.py).

Both play under the net's `INFERENCE_PRECISION`, as the JAX tests
play with cast variables: `greedy_mcts_policy` through the net's
per-version copy, `play_service` through the service's.

Termination is checked every `TERMINATION_CHECK_EVERY` moves, not every
move (each check is a host fetch); stepping finished lanes is a frozen
no-op, so the results are the same at any interval.
"""

from collections.abc import Callable

import numpy as np
import torch

from . import rng
from .serving.session import SessionSlots

TERMINATION_CHECK_EVERY = 8


def play(
    env,
    policy_fn: Callable,
    games: int,
    max_moves: int,
    seed: int,
    termination_check_every: int = TERMINATION_CHECK_EVERY,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Roll `games` paired hands under `policy_fn(states, move) -> (B,)
    actions`; returns (scores, lengths, done) as NumPy arrays."""
    slots = SessionSlots(env, games)
    slots.admit_many(rng.split(rng.PRNGKey(seed), games))
    mask = np.ones(games, dtype=bool)
    for move in range(max_moves):
        if move % termination_check_every == 0 and bool(slots.states.done.all()):
            break
        actions = policy_fn(slots.states, move)
        slots.step(torch.as_tensor(actions, dtype=torch.int64, device=env.device), mask)
    return slots.host_results()


def play_service(service, games: int, max_moves: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paired arena play through the policy service's request queue and
    dispatch: the same games as `play(env, greedy_mcts_policy(net,
    mcts), ...)` when the service wraps that (net, mcts), since each
    dispatch searches with `greedy_mcts_policy`'s key `PRNGKey(7000 +
    move)`. The service needs `games` free slots; sessions are retired
    as their games finish, and those still playing at `max_moves` are
    closed then."""
    if service.sessions.free_count < games:
        raise RuntimeError(
            f"play_service: {games} games need {games} free slots; only "
            f"{service.sessions.free_count} of {service.sessions.slots} free"
        )
    sessions = service.open_sessions(rng.split(rng.PRNGKey(seed), games))
    order = {s.sid: i for i, s in enumerate(sessions)}
    scores = np.zeros(games, dtype=np.float32)
    lengths = np.zeros(games, dtype=np.int32)
    done = np.zeros(games, dtype=bool)

    def close(sid: int) -> None:
        i = order[sid]
        summary = service.close_session(sid)
        scores[i] = summary["score"]
        lengths[i] = summary["moves"]
        done[i] = summary["done"]

    for s in sessions:
        service.request_move(s.sid)
    move = 0
    live = games
    while live > 0 and move < max_moves:
        results = service.dispatch(key=rng.PRNGKey(7000 + move))
        move += 1
        for r in results:
            if r["done"] or move >= max_moves:
                close(r["sid"])
                live -= 1
            else:
                service.request_move(r["sid"])
    for s in service.sessions.live_sessions():  # stragglers at max_moves
        if s.sid in order:
            close(s.sid)
    return scores, lengths, done


def random_policy(env, seed: int) -> Callable:
    """Uniform-random play over the valid actions, from a host NumPy
    generator of `seed` (the JAX package's `cli eval` baseline: the same
    draws over the same masks give the same games)."""
    pick = np.random.default_rng(seed)

    def policy(states, move):
        masks = env.valid_action_mask(states).cpu().numpy()
        logits = np.where(masks, pick.random(masks.shape), -np.inf)
        return np.where(masks.any(axis=1), logits.argmax(axis=1), 0)

    return policy


def greedy_mcts_policy(net, mcts) -> Callable:
    """Deterministic play from a search: its `root_actions` (the
    visit-count argmax, or a Gumbel search's own selection). Reads the net's
    installed weights at every call, at the run's inference precision
    (`NeuralNetwork.inference_model`, one cast per weights version), so one
    policy serves any number of weight restores (as
    `PolicyService.reload_weights`)."""

    def policy(states, move):
        mcts.model = net.inference_model()
        return mcts.root_actions(mcts.search(states, rng.PRNGKey(7000 + move)))

    return policy
