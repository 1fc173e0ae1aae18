"""The five BASELINE configurations as presets: counterpart of
`alphatriangle_tpu/config/presets.py`, field for field.

1. Default TrainConfig, CNN-only net, 50 simulations: the CPU smoke.
2. CNN-only net, 200 simulations, 128 lanes.
3. CNN + 4-layer transformer, Gumbel root search with playout-cap
   randomization, 512 lanes: the north-star recipe.
4. C51 value head, 4-layer transformer, 400 simulations, 512 lanes.
5. A 12x21 board and an 8-layer transformer with REMAT, 1024 lanes.

Lanes are the reference's worker counts 1/8/32/32/64 times 16.
`MeshConfig(DP_SIZE=-1)` resolves to the devices present: one card in
the port. `cli train --preset N` selects a preset, or a
`tuned_preset.json` written by the JAX package's autotuner (or by hand:
its model config is how a user sets NORM_TYPE and INFERENCE_PRECISION,
which reach the run's configs.json unchanged).
"""

import json
from pathlib import Path

from .env_config import EnvConfig
from .mcts_config import AlphaTriangleMCTSConfig
from .mesh_config import MeshConfig
from .model_config import ModelConfig
from .train_config import TrainConfig
from .validation import expected_other_features_dim

# Versioned schema tag of `tuned_preset.json` artifacts; a mismatched
# version is refused rather than half-understood.
TUNED_PRESET_SCHEMA = "alphatriangle.tuned_preset.v1"

PRESET_DESCRIPTIONS = {
    1: "CNN-only, 50 sims, CPU smoke (BASELINE config 1)",
    2: "CNN-only, 200 sims, single TPU core (BASELINE config 2)",
    3: (
        "CNN + 4-layer transformer, dp learner, Gumbel+PCR recipe "
        "(BASELINE config 3, north star)"
    ),
    4: "C51 + 400 sims (BASELINE config 4)",
    5: "Large board + 8-layer transformer (BASELINE config 5)",
}


def _large_board() -> EnvConfig:
    """12x21 symmetric board of preset 5 (the default's widening)."""
    rows, cols = 12, 21
    half = rows // 2
    ranges = []
    for r in range(rows):
        inset = max(0, (half - 1 - r) if r < half else (r - half))
        ranges.append((inset, cols - inset))
    return EnvConfig(ROWS=rows, COLS=cols, PLAYABLE_RANGE_PER_ROW=ranges)


def _tiny_board() -> EnvConfig:
    """3x4 fully playable board with one preview slot (the tests' world)."""
    return EnvConfig(
        ROWS=3,
        COLS=4,
        PLAYABLE_RANGE_PER_ROW=[(0, 4), (0, 4), (0, 4)],
        NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3,
        LINE_MIN_LENGTH=3,
    )


# Named board geometries; zero-argument constructors, so importing this
# module validates nothing.
GEOMETRY_PRESETS = {
    "tiny": _tiny_board,
    "default": EnvConfig,
    "large": _large_board,
}


def geometry_preset(name: str) -> EnvConfig:
    """EnvConfig of a named board geometry."""
    if name not in GEOMETRY_PRESETS:
        raise ValueError(
            f"Unknown geometry preset {name!r} (valid: {', '.join(sorted(GEOMETRY_PRESETS))})"
        )
    return GEOMETRY_PRESETS[name]()


def load_tuned_preset(path) -> dict[str, object]:
    """A `tuned_preset.json` artifact as a `baseline_preset`-shaped
    bundle {env, model, train, mcts, mesh, description, tuned}; `tuned`
    is the artifact itself. Raises ValueError with the reason on a
    missing or garbled file, a schema mismatch or configs that fail
    validation."""
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError as exc:
        raise ValueError(f"tuned preset {p}: unreadable ({exc})") from exc
    except json.JSONDecodeError as exc:
        raise ValueError(f"tuned preset {p}: invalid JSON ({exc})") from exc
    if not isinstance(payload, dict):
        raise ValueError(f"tuned preset {p}: expected a JSON object")
    schema = payload.get("schema")
    if schema != TUNED_PRESET_SCHEMA:
        raise ValueError(
            f"tuned preset {p}: schema {schema!r} does not match this build's "
            f"{TUNED_PRESET_SCHEMA!r}; re-run the tuner instead of reusing a stale artifact."
        )
    configs = payload.get("configs")
    if not isinstance(configs, dict):
        raise ValueError(f"tuned preset {p}: missing 'configs' section")
    try:
        env = EnvConfig(**configs["env"])
        model = ModelConfig(**configs["model"])
        train = TrainConfig(**configs["train"])
        mcts = AlphaTriangleMCTSConfig(**configs["mcts"])
    except KeyError as exc:
        raise ValueError(f"tuned preset {p}: configs section missing {exc}") from exc
    except (TypeError, ValueError) as exc:
        raise ValueError(f"tuned preset {p}: config validation failed ({exc})") from exc
    return {
        "env": env,
        "model": model,
        "train": train,
        "mcts": mcts,
        "mesh": MeshConfig(DP_SIZE=-1),
        "description": payload.get("description", f"tuned preset ({p.name})"),
        "tuned": payload,
    }


def baseline_preset(n: int, run_name: "str | None" = None) -> dict[str, object]:
    """Config bundle {env, model, train, mcts, mesh, description} of
    BASELINE config `n` (1..5). Knobs BASELINE does not pin keep their
    defaults."""
    if n not in PRESET_DESCRIPTIONS:
        raise ValueError(f"Unknown BASELINE preset {n} (valid: 1..5)")

    env = _large_board() if n == 5 else EnvConfig()
    model_kw: dict = {"OTHER_NN_INPUT_FEATURES_DIM": expected_other_features_dim(env)}
    if n in (1, 2):
        model_kw["USE_TRANSFORMER"] = False
    elif n in (3, 4):
        model_kw["TRANSFORMER_LAYERS"] = 4
    elif n == 5:
        model_kw["TRANSFORMER_LAYERS"] = 8
        model_kw["REMAT"] = True
    if n == 1:
        model_kw["COMPUTE_DTYPE"] = "float32"  # CPU smoke
    model = ModelConfig(**model_kw)

    train_kw: dict = {}
    if n == 1:
        # The CPU smoke by definition: `cli train` runs it on the CPU
        # unless --device says otherwise.
        train_kw["DEVICE"] = "cpu"
        train_kw["WORKER_DEVICE"] = "cpu"

    sims = {1: 50, 2: 200, 3: 64, 4: 400, 5: 64}[n]
    mcts_kw: dict = {}
    if n == 3:
        # The flagship recipe: Gumbel sequential-halving root and playout
        # cap randomization; the other presets keep PUCT.
        mcts_kw.update(root_selection="gumbel", fast_simulations=16, full_search_prob=0.25)
    mcts = AlphaTriangleMCTSConfig(max_simulations=sims, **mcts_kw)

    lanes = {1: 16, 2: 128, 3: 512, 4: 512, 5: 1024}[n]
    train = TrainConfig(
        SELF_PLAY_BATCH_SIZE=lanes,
        RUN_NAME=run_name or f"baseline_preset_{n}",
        FUSED_LEARNER_STEPS=1 if n == 1 else 16,
        **train_kw,
    )
    return {
        "env": env,
        "model": model,
        "train": train,
        "mcts": mcts,
        "mesh": MeshConfig(DP_SIZE=-1),
        "description": PRESET_DESCRIPTIONS[n],
    }
