"""`cli serve` of a trained run (`alphatriangle_tpu_torch/cli.py`), as
the JAX `cli serve --run-name` serves one (`alphatriangle_tpu/cli.py`
`cmd_serve`): the run's own `configs.json` (board, net, NORM_TYPE,
INFERENCE_PRECISION), its newest checkpoint restored as `cli eval`
restores it, and with `--reload-every N` a poll of the run's newest
committed checkpoint every N dispatches that hot-swaps a new step in.

The run here is a batch-norm net served at int8, its checkpoint written
by the port's `CheckpointManager`; a second checkpoint is committed
while the service runs.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch import serving  # noqa: E402
from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, precision  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, small_model_config, torch_cfg  # noqa: E402

RUN = "served"


def _write_run(root, env_cfg, model_cfg):
    """A run directory with configs.json and a checkpoint at step 1;
    returns (manager, trainer, the step directory)."""
    mgr = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(root), RUN_NAME=RUN))
    mgr.save_configs({"env": env_cfg, "model": model_cfg})
    trainer = Trainer(NeuralNetwork(model_cfg, env_cfg, seed=2, device=CPU), TrainConfig(RUN_NAME=RUN))
    return mgr, trainer, mgr.save(1, trainer.get_state())


def _serve(args: list, capsys) -> tuple[int, dict]:
    rc = cli.main(["serve", "--device", "cpu", "--slots", "2", "--sims", "4", *args])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_run_name_reads_configs_and_reloads(monkeypatch, tmp_path, tiny_env_config, capsys):
    env_cfg = torch_cfg(tiny_env_config)
    model_cfg = torch_cfg(small_model_config(
        tiny_env_config, NORM_TYPE="batch", INFERENCE_PRECISION="int8"
    ))
    mgr, trainer, _ = _write_run(tmp_path, env_cfg, model_cfg)
    served = {}
    real_load = serving.run_simulated_load

    def load(service, **kw):
        hook = kw["reload_hook"]

        def reload_hook(svc, dispatches):
            if dispatches == 2:  # the learner commits step 2 while serving
                with torch.no_grad():
                    for p in trainer.model.parameters():
                        p.add_(0.01)
                mgr.save(2, trainer.get_state())
            hook(svc, dispatches)
            if dispatches == 4:
                served["net"] = svc.net
                served["model"] = svc.mcts.model

        return real_load(service, **{**kw, "reload_hook": reload_hook})

    monkeypatch.setattr(serving, "run_simulated_load", load)
    casts = precision.InferenceNet.casts
    rc, report = _serve([
        "--run-name", RUN, "--root-dir", str(tmp_path), "--sessions", "2", "--max-moves", "8",
        "--reload-every", "2",
    ], capsys)
    assert rc == 0 and report["sessions_served"] == 2
    assert report["source"] == "step 1" and report["run_name"] == RUN
    assert (report["inference_precision"], report["norm_type"]) == ("int8", "batch")
    assert report["reloaded_steps"] == [2] and report["serve_weight_reloads"] == 1
    assert report["dispatches"] >= 4
    # The served weights are step 2's, read through their int8 copy:
    # one cast before the reload and one after.
    net = served["net"]
    assert net.model_config.INFERENCE_PRECISION == "int8"
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(net.model.state_dict()[name], p), name
    assert isinstance(served["model"], precision.InferenceNet)
    assert precision.InferenceNet.casts == casts + 2


def test_serve_checkpoint_and_no_reload(tmp_path, tiny_env_config, capsys):
    """A step directory serves on its run's configs; `--reload-every 0`
    polls nothing."""
    env_cfg = torch_cfg(tiny_env_config)
    model_cfg = torch_cfg(small_model_config(tiny_env_config, INFERENCE_PRECISION="bfloat16"))
    _, _, step_dir = _write_run(tmp_path, env_cfg, model_cfg)
    rc, report = _serve([
        "--checkpoint", str(step_dir), "--sessions", "2", "--max-moves", "3", "--reload-every", "0",
    ], capsys)
    assert rc == 0 and report["source"] == "step 1"
    assert report["inference_precision"] == "bfloat16" and report["reloaded_steps"] == []
    rc, report = _serve([
        "--run-name", "absent", "--root-dir", str(tmp_path), "--sessions", "1", "--max-moves", "2",
    ], capsys)
    assert rc == 0 and report["source"] == "untrained"
    assert report["inference_precision"] == "float32"  # no configs.json: the defaults


def test_tuned_preset_and_configs_json_carry_norm_and_precision(tmp_path, capsys):
    """How a user sets NORM_TYPE and INFERENCE_PRECISION: a tuned-preset
    artifact (`cli train --preset PATH`), whose model config reaches the
    run's configs.json, which `cli serve` / `cli eval` then read; both
    packages read both files alike."""
    from alphatriangle_tpu.config import load_tuned_preset as jax_load_tuned
    from alphatriangle_tpu.config.run_configs import load_run_configs as jax_load_run
    from alphatriangle_tpu_torch.config import load_tuned_preset
    from alphatriangle_tpu_torch.config.run_configs import load_run_configs
    from test_torch_presets import _artifact, jax_preset

    model = jax_preset(2, run_name="tuned")["model"].model_dump()
    model.update(NORM_TYPE="batch", INFERENCE_PRECISION="int8")
    path = _artifact(tmp_path, model=model)
    ours, theirs = load_tuned_preset(path)["model"], jax_load_tuned(path)["model"]
    assert (ours.NORM_TYPE, ours.INFERENCE_PRECISION) == ("batch", "int8")
    assert ours.model_dump() == theirs.model_dump()
    rc = cli.main(["train", "--preset", path, "--dry-setup", "--device", "cpu", "--root-dir",
                   str(tmp_path), "--buffer-capacity", "64", "--min-buffer", "64",
                   "--batch-size", "8", "--run-name", "tuned_bn", "--no-tensorboard"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["dry_setup"]
    run_dir = report["run_dir"]
    for loaded in (load_run_configs(run_dir)["model"], jax_load_run(run_dir)["model"]):
        assert (loaded.NORM_TYPE, loaded.INFERENCE_PRECISION) == ("batch", "int8")
