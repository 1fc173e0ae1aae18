"""Checkpoint, buffer spill and restore: counterpart of
`alphatriangle_tpu/stats/persistence.py` (`CheckpointManager`,
`LoadedTrainingState`) with the learner state as torch tensors.

A run directory (`config/persistence_config.py`) holds, per saved step:

- `checkpoints/step_NNNNNNNN/train_state.pt`: `Trainer.get_state()`'s
  snapshot (CPU tensors: parameters, a batch-norm net's running
  statistics under `batch_stats`, the Adam state, step and key) written
  by `torch.save` to a tmp name in the step directory, then
  `os.replace`d; a snapshot written before `batch_stats` was carried
  loads into a net that has none;
- `checkpoints/step_NNNNNNNN.meta.json`: `global_step` and the loop's
  counters (tmp + `os.replace`);
- `checkpoints/step_NNNNNNNN.commit`: written only once the tree and the
  meta are on disk; restore skips a step without it (when the run has
  markers at all) or with unparseable meta, and falls back past a tree
  it cannot read;
- `buffers/buffer_NNNNNNNN.npz`: the replay ring's snapshot under the
  JAX spill's keys (`pos`, `size`, `storage_<column>`, `priorities`),
  written as `.tmp_buffer_NNNNNNNN.npz` and `os.replace`d, so a kill
  mid-write leaves no torn spill under the name restore reads. Either
  package loads the other's spill (`np.load` reads it whether or not it
  is compressed; the port writes it uncompressed, a fraction of the
  time a 250,000-row ring takes to deflate). A torn spill falls back to
  the one before;
- `configs.json`: the run's configs under the JAX dump's keys.

Under `ALPHATRIANGLE_FAULTS` the chaos drills' `checkpoint-save` site
(`supervise/faults.py`: sigkill-save) fires between the meta and the
commit marker.

Retention keeps the newest `KEEP_LAST_CHECKPOINTS` steps and
`KEEP_LAST_BUFFERS` spills (0 keeps all). The JAX package writes its
Orbax trees asynchronously and commits them from a background flusher
thread; here the save is synchronous (the state is copied to the host
before `save` returns, since the optimizer updates the live tensors in
place), so the marker is written in line and there is no flusher.
Loading uses `torch.load(..., map_location=<run device>,
weights_only=True)`.

`timings` keeps the host seconds of each save, spill and restore and the
bytes of each spill.
"""

import json
import logging
import os
import re
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config.persistence_config import PersistenceConfig

logger = logging.getLogger(__name__)

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_COMMIT_RE = re.compile(r"^step_(\d+)\.commit$")
STATE_FILENAME = "train_state.pt"


def _atomic_write_text(path: Path, text: str) -> None:
    """Write `text` to `path` via tmp + os.replace: readers see the old
    content or the new, never a torn half."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _committed_steps(ckpt_dir: Path) -> set[int]:
    return {
        int(m.group(1)) for p in ckpt_dir.glob("step_*.commit") if (m := _COMMIT_RE.match(p.name))
    }


@dataclass
class LoadedTrainingState:
    """Everything a resumed run needs."""

    train_state: "dict | None" = None
    buffer_loaded: bool = False
    counters: dict[str, Any] = field(default_factory=dict)
    run_name: "str | None" = None
    global_step: int = 0


class CheckpointManager:
    """Owns one run's checkpoint and buffer directories. `device` is where
    a restored state's tensors land (the run's device)."""

    def __init__(self, persistence: PersistenceConfig, device="cpu", create_dirs: bool = True):
        self.config = persistence
        self.device = torch.device(device)
        if create_dirs:
            persistence.create_run_dirs()
        self._ckpt_dir = persistence.get_checkpoint_dir().resolve()
        self._buffer_dir = persistence.get_buffer_dir().resolve()
        self.timings: dict[str, list] = {
            "save_s": [], "spill_s": [], "spill_bytes": [], "restore_state_s": [],
            "restore_buffer_s": [],
        }

    # --- save -------------------------------------------------------------

    def _commit_marker_path(self, step: int) -> Path:
        return self._ckpt_dir / f"step_{step:08d}.commit"

    def save(self, step: int, train_state: dict, counters: "dict[str, Any] | None" = None) -> Path:
        """Checkpoint a `Trainer.get_state()` snapshot and the counters;
        returns the step directory. A step saved again (the forced final
        save) replaces the earlier one."""
        t0 = time.perf_counter()
        path = self._ckpt_dir / f"step_{step:08d}"
        if path.exists():
            self._commit_marker_path(step).unlink(missing_ok=True)
            shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        tmp = path / f".tmp_{STATE_FILENAME}"
        torch.save(train_state, tmp)
        os.replace(tmp, path / STATE_FILENAME)
        _atomic_write_text(
            self._ckpt_dir / f"step_{step:08d}.meta.json",
            json.dumps({"global_step": step, **(counters or {})}, indent=2),
        )
        if os.environ.get("ALPHATRIANGLE_FAULTS"):
            # The chaos drills' checkpoint-save site (supervise/faults.py:
            # sigkill-save): the state and the meta are on disk, the
            # commit marker is not, so a kill here leaves a torn step.
            from ..supervise.faults import fault_point

            fault_point("checkpoint-save", step)
        _atomic_write_text(self._commit_marker_path(step), json.dumps({"global_step": step}))
        self.timings["save_s"].append(time.perf_counter() - t0)
        logger.info("Checkpoint saved at step %d -> %s", step, path)
        self._prune_checkpoints()
        return path

    def _prune_checkpoints(self) -> None:
        keep = self.config.KEEP_LAST_CHECKPOINTS
        steps = self.list_steps()
        if keep <= 0 or len(steps) <= keep:
            return
        for step in steps[:-keep]:
            shutil.rmtree(self._ckpt_dir / f"step_{step:08d}", ignore_errors=True)
            (self._ckpt_dir / f"step_{step:08d}.meta.json").unlink(missing_ok=True)
            self._commit_marker_path(step).unlink(missing_ok=True)
            logger.debug("Pruned checkpoint step %d", step)

    def _prune_buffers(self) -> None:
        keep = self.config.KEEP_LAST_BUFFERS
        if keep <= 0:
            return
        spills = sorted(self._buffer_dir.glob("buffer_*.npz"))
        for path in spills[:-keep] if len(spills) > keep else []:
            path.unlink(missing_ok=True)
            logger.debug("Pruned buffer spill %s", path.name)

    def save_buffer(self, step: int, buffer) -> "Path | None":
        """Spill the replay ring (host or device); None when it is empty."""
        t0 = time.perf_counter()
        state = buffer.get_state()
        if state["storage"] is None:
            return None
        path = self._buffer_dir / f"buffer_{step:08d}.npz"
        arrays = {f"storage_{k}": v for k, v in state["storage"].items()}
        if state["priorities"] is not None:
            arrays["priorities"] = state["priorities"]
        # The tmp name keeps the .npz suffix (np.savez appends it
        # otherwise) but dodges the buffer_*.npz glob.
        tmp = self._buffer_dir / f".tmp_buffer_{step:08d}.npz"
        np.savez(tmp, pos=state["pos"], size=state["size"], **arrays)
        os.replace(tmp, path)
        self.timings["spill_s"].append(time.perf_counter() - t0)
        self.timings["spill_bytes"].append(path.stat().st_size)
        logger.info("Buffer spilled (%d experiences) -> %s", state["size"], path)
        self._prune_buffers()
        return path

    def save_configs(self, configs: dict[str, Any]) -> None:
        """Dump the configs to the run directory's configs.json."""
        out = {k: (v.model_dump() if hasattr(v, "model_dump") else v) for k, v in configs.items()}
        _atomic_write_text(
            self.config.get_run_base_dir() / "configs.json",
            json.dumps(out, indent=2, default=str),
        )

    # --- load -------------------------------------------------------------

    def list_steps(self) -> list[int]:
        """Sorted steps of every step directory (other names ignored)."""
        if not self._ckpt_dir.exists():
            return []
        return sorted(
            int(m.group(1))
            for p in self._ckpt_dir.iterdir()
            if p.is_dir() and (m := _STEP_DIR_RE.match(p.name))
        )

    def valid_steps(self) -> list[int]:
        """Steps restore may trust: committed (when the run has markers at
        all) with parseable meta.json."""
        steps = self.list_steps()
        if not steps:
            return []
        committed = _committed_steps(self._ckpt_dir)
        valid: list[int] = []
        for step in steps:
            if committed and step not in committed:
                logger.warning(
                    "Checkpoint step %d has no commit marker (torn save?); skipping it", step
                )
                continue
            try:
                json.loads((self._ckpt_dir / f"step_{step:08d}.meta.json").read_text())
            except (OSError, ValueError):
                logger.warning("Checkpoint step %d has no parseable meta.json; skipping it", step)
                continue
            valid.append(step)
        return valid

    def latest_step(self) -> "int | None":
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def _load_tree(self, path: Path) -> dict:
        t0 = time.perf_counter()
        state = torch.load(path / STATE_FILENAME, map_location=self.device, weights_only=True)
        self.timings["restore_state_s"].append(time.perf_counter() - t0)
        return state

    def restore(self, step: "int | None" = None, buffer=None) -> LoadedTrainingState:
        """Restore the checkpoint at `step` (default: the newest valid
        one), and into `buffer`, when given, the newest spill at or before
        it. An explicit `step` is trusted (errors propagate); otherwise an
        unreadable tree falls back to the previous valid step."""
        if step is not None:
            candidates, fallback = [step], False
        else:
            candidates, fallback = list(reversed(self.valid_steps())), True
        if not candidates:
            torn = self.list_steps()
            if torn:
                logger.warning("No committed checkpoint among step dirs %s; starting fresh", torn)
            return LoadedTrainingState(run_name=self.config.RUN_NAME)
        last_exc: "Exception | None" = None
        for cand in candidates:
            path = self._ckpt_dir / f"step_{cand:08d}"
            try:
                restored = self._load_tree(path)
            except Exception as exc:
                if not fallback:
                    raise
                last_exc = exc
                logger.warning(
                    "Checkpoint step %d unreadable (%s); falling back to the previous valid step",
                    cand, exc,
                )
                continue
            counters = self._read_meta(path)
            buffer_loaded = False
            if buffer is not None:
                buffer_loaded = self.restore_buffer(buffer, max_step=cand)
            logger.info("Restored checkpoint step %d from %s (buffer=%s)", cand, path, buffer_loaded)
            return LoadedTrainingState(
                train_state=restored,
                buffer_loaded=buffer_loaded,
                counters=counters,
                run_name=self.config.RUN_NAME,
                global_step=int(counters.get("global_step", cand)),
            )
        assert last_exc is not None
        raise last_exc

    @staticmethod
    def _read_meta(path: Path) -> dict[str, Any]:
        meta_path = path.parent / f"{path.name}.meta.json"
        if not meta_path.exists():
            return {}
        try:
            return json.loads(meta_path.read_text())
        except ValueError:
            return {}

    def restore_path(self, path: "str | Path") -> LoadedTrainingState:
        """Restore an explicit step directory (`LOAD_CHECKPOINT_PATH`)."""
        path = Path(path).resolve()
        if not path.is_dir():
            raise FileNotFoundError(f"No checkpoint directory at {path}")
        restored = self._load_tree(path)
        counters = self._read_meta(path)
        m = _STEP_DIR_RE.match(path.name)
        step = int(counters.get("global_step", int(m.group(1)) if m else 0))
        return LoadedTrainingState(
            train_state=restored, counters=counters, run_name=self.config.RUN_NAME,
            global_step=step,
        )

    def restore_buffer_path(self, buffer, path: "str | Path") -> bool:
        """Load an explicit buffer spill (`LOAD_BUFFER_PATH`)."""
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"No buffer spill at {path}")
        self._load_spill_into(buffer, path)
        return True

    def restore_buffer(self, buffer, max_step: "int | None" = None) -> bool:
        """Load the newest spill (at or before `max_step`) into `buffer`;
        a torn spill falls back to the one before."""
        if not self._buffer_dir.exists():
            return False
        spills = sorted(self._buffer_dir.glob("buffer_*.npz"))
        if max_step is not None:
            spills = [s for s in spills if int(s.stem.split("_")[1]) <= max_step]
        for spill in reversed(spills):
            try:
                self._load_spill_into(buffer, spill)
                return True
            except Exception as exc:
                logger.warning(
                    "Buffer spill %s unreadable (%s); falling back to the previous spill",
                    spill.name, exc,
                )
        return False

    def _load_spill_into(self, buffer, path: Path) -> None:
        t0 = time.perf_counter()
        buffer.set_state(load_spill(path))
        self.timings["restore_buffer_s"].append(time.perf_counter() - t0)

    # --- auto-resume ------------------------------------------------------

    @staticmethod
    def find_latest_run(persistence: PersistenceConfig) -> "str | None":
        """The newest run (by its step directories' mtime) with at least
        one committed step (or any step, in a run without markers)."""
        runs_root = persistence.get_runs_root_dir()
        if not runs_root.exists():
            return None
        candidates: list[tuple[float, str]] = []
        for run_dir in runs_root.iterdir():
            ckpts = run_dir / "checkpoints"
            if not ckpts.is_dir():
                continue
            committed = _committed_steps(ckpts)
            steps = [
                p
                for p in ckpts.iterdir()
                if p.is_dir()
                and (m := _STEP_DIR_RE.match(p.name))
                and (not committed or int(m.group(1)) in committed)
            ]
            if steps:
                candidates.append((max(p.stat().st_mtime for p in steps), run_dir.name))
        if not candidates:
            return None
        return max(candidates)[1]


def load_spill(path: "str | Path") -> dict[str, Any]:
    """A buffer spill (either package's) as a `set_state` snapshot."""
    with np.load(path) as data:
        storage = {k[len("storage_"):]: data[k] for k in data.files if k.startswith("storage_")}
        return {
            "pos": int(data["pos"]),
            "size": int(data["size"]),
            "storage": storage,
            "priorities": data["priorities"] if "priorities" in data.files else None,
        }
