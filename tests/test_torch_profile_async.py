"""`cli train --profile` of the overlapped loop, the port's against the JAX
package's: the phase timers' names (`test_torch_profiling.py` holds the rest
of the profiling plane; `assert_phases_match` says what is compared)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_profiling import assert_phases_match, profiled_run  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)


def test_cli_train_profile_async_phases_match_jax(tmp_path, capsys, tiny_env_config, tiny_model_config):
    ours, theirs, report = profiled_run(tmp_path, tiny_env_config, tiny_model_config, "async", capsys)
    assert_phases_match(ours, theirs, report, "async")
