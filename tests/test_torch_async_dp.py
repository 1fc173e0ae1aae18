"""The overlapped loop over data-parallel ranks (`cli train --distributed
--async-rollouts`) of the port on the CPU: two gloo ranks, each a `cli
train` in a process of its own (`torch_parity.spawn_ranks`, scenario
`cli_train` of `tests/torch_dp_rank.py`).

- The port's counterpart of JAX
  `tests/test_sharded_device_buffer.py::TestLoopEndToEnd::
  test_overlapped_loop_on_sharded_ring` (`ASYNC_ROLLOUTS`,
  `DEVICE_REPLAY="on"`, `ASYNC_CHUNK_SECONDS=None`, two streams a rank),
  on the sharded device ring and on each rank's own host ring: the run
  completes at MAX_TRAINING_STEPS on both ranks, in the same beats, and
  the replicas' parameter digests agree after every beat that trained.
- The chunk auto-tune takes the slowest rank's timed chunk: with rank 1's
  timed chunk slowed past the target, both ranks' producers play the
  length rank 1 alone would tune to, one move, where rank 0 alone would
  keep two or three.
- A rank whose producer stream used up its restarts
  (`PRODUCER_MAX_RESTARTS=0`, a fault injected into its producers' chunks)
  stops both ranks at the same beat, within the ranks' time limit: the
  faulty rank ends in error, its peer stops with it, and both counted the
  same beats and learner steps.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_parity import collect_ranks, spawn_ranks, tiny_preset  # noqa: E402

TRAIN = ["train", "--device", "cpu", "--self-play-batch", "4", "--batch-size", "8", "--min-buffer", "8",
         "--buffer-capacity", "64", "--rollout-chunk", "3", "--fused-learner-steps", "2",
         "--workers", "2", "--async-rollouts", "--no-tensorboard", "--no-auto-resume", "--seed", "3",
         "--log-level", "WARNING"]


def _run(tmp_path, env_cfg, model_cfg, *flags, crash=None, slow=None, **train) -> list:
    preset = tiny_preset(tmp_path / "preset.json", env_cfg, model_cfg, **train)
    spec = {"scenario": "cli_train", "crash": crash, "slow": slow,
            "argv": [*TRAIN, "--preset", preset, "--root-dir", str(tmp_path / "runs"), *flags]}
    return [r["report"] | {"rc": r["rc"]} for r in collect_ranks(*spawn_ranks(spec, tmp_path))]


@pytest.mark.parametrize("ring", ["on", "off"])
def test_overlapped_loop_over_two_ranks(tmp_path, tiny_env_config, tiny_model_config, ring):
    r0, r1 = _run(tmp_path, tiny_env_config, tiny_model_config, "--max-steps", "3", "--run-name",
                  f"async_{ring}", "--device-replay", ring, ASYNC_CHUNK_SECONDS=None)
    for r in (r0, r1):
        assert (r["rc"], r["status"], r["mode"]) == (0, "completed", "async"), r["error"]
        assert r["replay_ring"] == ("device" if ring == "on" else "host")
        assert r["steps"] == 3 and r["dp"]["world"] == 2 and r["dp"]["backend"] == "gloo"
        assert set(r["harvests_by_stream"]) == {"0", "1"}
    assert r0["iterations"] == r1["iterations"]
    assert r0["losses"] == r1["losses"]
    digests = r0["dp"]["param_checksums"]
    assert digests and digests == r1["dp"]["param_checksums"]


def test_one_tuned_chunk_on_both_ranks(tmp_path, tiny_env_config, tiny_model_config):
    # Rank 1's timed chunk of 3 moves takes over 6 s, so alone it tunes
    # to round(2 / (6 / 3)) = 1 move for the 2 s target; rank 0's takes
    # well under 1.33 s a move here, so alone it would keep 2 or 3. The
    # ranks take the slowest measurement: both play 1-move chunks.
    r0, r1 = _run(tmp_path, tiny_env_config, tiny_model_config, "--max-steps", "2", "--run-name", "tuned",
                  slow={"rank": 1, "seconds": 6.0}, ASYNC_CHUNK_SECONDS=2.0)
    assert (r0["status"], r1["status"]) == ("completed", "completed")
    assert r0["tuned_chunk_moves"] == r1["tuned_chunk_moves"] == 1
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]


def test_exhausted_producer_stops_both_ranks_at_one_beat(tmp_path, tiny_env_config, tiny_model_config):
    r0, r1 = _run(tmp_path, tiny_env_config, tiny_model_config, "--max-steps", "200", "--run-name", "crash",
                  crash={"rank": 1, "after": 1}, ASYNC_CHUNK_SECONDS=None, PRODUCER_MAX_RESTARTS=0)
    assert (r1["rc"], r1["status"]) == (1, "error") and "injected producer fault" in r1["error"]
    assert (r0["rc"], r0["status"]) == (0, "completed")
    assert r0["iterations"] == r1["iterations"] and r0["steps"] == r1["steps"] < 200
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]
