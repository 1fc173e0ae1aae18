"""The PyTorch port's overlapped training loop (`ASYNC_ROLLOUTS`) on the
CPU, held to the contracts of its JAX twins in
`tests/test_training_loop.py::TestAsyncLoop`: a run reaches
MAX_TRAINING_STEPS with the weight-sync cadence, producer threads shut
down, several streams feed one queue, the replay-ratio gate holds, the
learner completes with the pipeline off and with fused groups in it,
one clean measurement tunes the chunk length, the stream count clamps
to the host, a persistent producer crash ends the run with its error
after bounded respawns, and a transient one heals. Beyond the JAX
tests: the device ring's payload hand-off, and that every chunk reads
one set of weights while the learner syncs from the main thread. The
producers' harvests arrive in an order the threads decide, so these
tests hold counts and invariants, not values (the synchronous loop is
held to JAX's values in `test_torch_sync_loop.py`)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch.config import TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine  # noqa: E402
from alphatriangle_tpu_torch.training import (  # noqa: E402
    LoopStatus,
    TrainingLoop,
    clamp_self_play_workers,
    setup_training_components,
)
from alphatriangle_tpu_torch.training import setup as setup_mod  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, run_root, torch_cfg  # noqa: E402


def _loop(root, env_cfg, model_cfg, mcts_cfg, **kw) -> TrainingLoop:
    """The JAX async tests' tiny run (tests/test_training_loop.py)."""
    base = dict(
        RUN_NAME="async", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8, SELF_PLAY_BATCH_SIZE=4,
        ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000, MIN_BUFFER_SIZE_TO_TRAIN=16,
        USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2, WORKER_UPDATE_FREQ_STEPS=2,
        MAX_EPISODE_MOVES=30, RANDOM_SEED=5, ASYNC_ROLLOUTS=True,
    )
    base.update(kw)
    c = setup_training_components(
        TrainConfig(**base), torch_cfg(env_cfg), torch_cfg(model_cfg), torch_cfg(mcts_cfg),
        persistence_config=run_root(root), device=CPU,
    )
    return TrainingLoop(c)


@pytest.fixture
def tiny(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
    return lambda **kw: _loop(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config, **kw)


def _producers_alive() -> bool:
    return any(t.name.startswith("self-play-producer") and t.is_alive() for t in threading.enumerate())


def _consistent(loop: TrainingLoop) -> None:
    c = loop.c
    assert loop.experiences_added == len(c.buffer) > 0
    assert loop._steps_this_run * c.train_config.BATCH_SIZE <= (
        loop.experiences_added * c.train_config.REPLAY_RATIO
    )
    assert not loop._inflight and not _producers_alive()
    assert all(np.isfinite(m["total_loss"]) for m in loop.metrics)
    assert [m["step"] for m in loop.metrics] == list(range(1, loop.global_step + 1))


class TestAsyncLoop:
    def test_async_end_to_end(self, tiny):
        loop = tiny(REPLAY_RATIO=1.0)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.global_step == 8
        # The weight-sync cadence holds here too (every 2 steps -> 4).
        assert loop.weight_updates == 4 == loop.c.net.weights_version
        assert loop.queue_depths and loop.report()["replay_ratio"] <= 1.0
        assert not loop.c.buffer.is_device  # "auto" on the CPU
        _consistent(loop)

    def test_multi_stream_producers(self, tiny):
        loop = tiny(NUM_SELF_PLAY_WORKERS=2, MAX_TRAINING_STEPS=4)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.global_step == 4
        assert set(loop._streams) == {0, 1}
        assert loop._streams[0]["engine"] is loop.c.self_play
        assert loop._streams[1]["engine"].batch_size == loop.c.self_play.batch_size
        _consistent(loop)

    def test_replay_ratio_gate(self, tiny):
        loop = tiny(REPLAY_RATIO=0.5, MAX_TRAINING_STEPS=4)
        assert loop.run() == LoopStatus.COMPLETED
        consumed = loop._steps_this_run * loop.cfg.BATCH_SIZE
        assert consumed <= loop.experiences_added * 0.5 + 1e-9
        _consistent(loop)

    def test_pipeline_disabled_still_completes(self, tiny):
        loop = tiny(PIPELINE_LEARNER=False, MAX_TRAINING_STEPS=4)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.global_step == 4
        _consistent(loop)

    def test_pipelined_fused_groups_on_the_device_ring(self, tiny):
        """Fused groups in the pipeline, drawn from the device ring, whose
        rows arrive as the producers' device payloads."""
        loop = tiny(FUSED_LEARNER_STEPS=2, DEVICE_REPLAY="on", NUM_SELF_PLAY_WORKERS=2)
        assert loop.c.buffer.is_device
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.global_step == 8 and loop.weight_updates == 4
        assert loop.c.trainer.dispatch_count <= 8  # some steps ran as fused pairs
        _consistent(loop)

    def test_async_chunk_autotune(self, tiny):
        loop = tiny(ASYNC_CHUNK_SECONDS=2.0)
        # Not warmed (the first chunk): no tuning.
        loop._maybe_tune_chunk(4, dt=4.0, warmed=False)
        assert loop._tuned_chunk_moves is None and loop._producer_chunk_moves() == 4
        # 4 moves took 4 s -> 1 s/move -> 2 moves fit the 2 s target.
        loop._maybe_tune_chunk(4, dt=4.0, warmed=True)
        assert loop._tuned_chunk_moves == 2 and loop._producer_chunk_moves() == 2
        # The first measurement wins.
        loop._maybe_tune_chunk(2, dt=0.1, warmed=True)
        assert loop._tuned_chunk_moves == 2
        # A run records what it chose, never above ROLLOUT_CHUNK_MOVES.
        run = tiny(MAX_TRAINING_STEPS=2)
        assert run.run() == LoopStatus.COMPLETED
        assert 1 <= run.report()["tuned_chunk_moves"] <= 4

    def test_worker_clamp(self, monkeypatch):
        monkeypatch.setattr(setup_mod.os, "cpu_count", lambda: 4)
        assert clamp_self_play_workers(1, CPU) == 1
        assert clamp_self_play_workers(2, CPU) == 2
        assert clamp_self_play_workers(8, CPU) == 2  # cores - 2 on the CPU
        monkeypatch.setattr(setup_mod.os, "cpu_count", lambda: 64)
        assert clamp_self_play_workers(10_000, CPU) == setup_mod.MAX_STREAMS_PER_DEVICE
        monkeypatch.setattr(setup_mod.os, "cpu_count", lambda: 1)
        assert clamp_self_play_workers(8, CPU) == 1
        # On a card the streams wait on the device: cores do not bind.
        assert clamp_self_play_workers(3, torch.device("cuda")) == 3
        assert clamp_self_play_workers(8, torch.device("cuda")) == setup_mod.MAX_STREAMS_PER_DEVICE

    def test_producer_error_surfaces(self, tiny, monkeypatch):
        """A persistent crash (patched at class level, so respawned
        engines crash too) ends the run with the producer's error after
        the configured respawns."""

        def boom(self, num_moves):
            raise RuntimeError("producer crashed")

        loop = tiny(
            ASYNC_CHUNK_SECONDS=None, PRODUCER_MAX_RESTARTS=1, PRODUCER_RESTART_BACKOFF_S=0.01
        )
        monkeypatch.setattr(SelfPlayEngine, "play_moves", boom)
        assert loop.run() == LoopStatus.ERROR
        assert loop.producer_restarts == 1
        assert isinstance(loop.error, RuntimeError) and "producer crashed" in str(loop.error)
        assert loop.report()["error"] == repr(loop.error)
        assert not _producers_alive()

    def test_producer_respawn_recovers(self, tiny, monkeypatch):
        real = SelfPlayEngine.play_moves
        fails = {"left": 2}
        lock = threading.Lock()

        def flaky(self, num_moves):
            with lock:
                fail = fails["left"] > 0
                fails["left"] -= fail
            if fail:
                raise RuntimeError("transient device fault")
            return real(self, num_moves)

        loop = tiny(
            ASYNC_CHUNK_SECONDS=None, PRODUCER_MAX_RESTARTS=3, PRODUCER_RESTART_BACKOFF_S=0.01
        )
        monkeypatch.setattr(SelfPlayEngine, "play_moves", flaky)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.producer_restarts == 2 and loop.global_step == 8
        _consistent(loop)

    def test_every_chunk_reads_one_set_of_weights(self, tiny, monkeypatch):
        """Two producers play while the main thread syncs every 2 steps:
        within each chunk every move searches with one module under one
        version, the one the net held when the chunk began."""
        chunks, lock = [], threading.Lock()
        real_chunk, real_body = SelfPlayEngine._chunk, SelfPlayEngine._move_body
        local = threading.local()

        def chunk(self, num_moves, carry, weights=None):
            local.moves = []
            out = real_chunk(self, num_moves, carry, weights)
            with lock:
                chunks.append((weights, local.moves))
            return out

        def body(self, carry, version):
            local.moves.append((self.mcts.model, version))
            return real_body(self, carry, version)

        monkeypatch.setattr(SelfPlayEngine, "_chunk", chunk)
        monkeypatch.setattr(SelfPlayEngine, "_move_body", body)
        loop = tiny(NUM_SELF_PLAY_WORKERS=2, ROLLOUT_CHUNK_MOVES=2, WORKER_UPDATE_FREQ_STEPS=1)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.weight_updates == 8
        assert len(chunks) >= 4
        for weights, moves in chunks:
            assert len(moves) == 2
            assert all(m is weights.model and v == weights.version for m, v in moves)
        assert max(w.version for w, _ in chunks) > 0
        _consistent(loop)
