"""The single-state API and `cli play` of the port against the JAX
package's, on the CPU.

- `GameState`: a game from one seed, played to its end, equals the JAX
  package's at every move (grid, colors, hand, score, step, cleared
  triangles, valid actions, `is_over`, the step's reward); `copy()`
  forks it.
- The native host engine (`env/native/`, the port's own `engine.cpp`
  built into `_build/`): the same batches and actions give the JAX
  native engine's states bit for bit, and its refill-free transitions
  and masks equal the port's tensor engine's (skipped, with the reason,
  only when g++ is missing).
- `extract_state_features` equals the JAX extractor's features run op by
  op exactly, and the JAX package's `extract_state_features` (jitted)
  within one float32 rounding (XLA turns a division by a constant, the
  score's /100, the holes' and bumpiness' scalings, the step's /1000,
  into a product with the constant's float32 reciprocal; the port
  divides, as the op-by-op JAX run does).
- `NeuralNetwork.evaluate_state` / `evaluate_batch` against the JAX
  package's through the weight converter, within the float32 forward's
  tolerance (1e-5, `tests/test_torch_net.py`), batches of 1 to 5 (the
  JAX package pads them to 8); the batch equals the single states.
- `cli play --script` prints the JAX command's transcript line for line
  but for the engine's name, with either engine; the `jax` engine needs a
  card unless `--device cpu`.
- `render_grid` / `render_shape`, `is_point_in_polygon` and `APP_NAME`.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu import cli as jcli  # noqa: E402
from alphatriangle_tpu.config import EnvConfig as JaxEnvConfig  # noqa: E402
from alphatriangle_tpu.env import native as jnative  # noqa: E402
from alphatriangle_tpu.env.game_state import GameState as JaxGameState  # noqa: E402
from alphatriangle_tpu.env.render import render_grid as jrender_grid  # noqa: E402
from alphatriangle_tpu.env.render import render_shape as jrender_shape  # noqa: E402
from alphatriangle_tpu.features.extractor import (  # noqa: E402
    extract_state_features as jextract,
)
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.utils.geometry import is_point_in_polygon as jinside  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch import config as tconfig  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import GameState, TriangleEnv, get_env  # noqa: E402
from alphatriangle_tpu_torch.env import native as tnative  # noqa: E402
from alphatriangle_tpu_torch.env.render import render_grid, render_shape  # noqa: E402
from alphatriangle_tpu_torch.features import extract_state_features  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.utils.geometry import is_point_in_polygon  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, converted_state_dict, small_model_config, torch_cfg  # noqa: E402

F32_TOL = 1e-5
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")


def _pick(mask: np.ndarray, gen) -> int:
    valid = np.flatnonzero(mask)
    return int(valid[gen.integers(len(valid))]) if len(valid) else 0


def _assert_same_game(t: GameState, j: JaxGameState) -> None:
    tg, jg = t.get_grid_data_np(), j.get_grid_data_np()
    for key in ("occupied", "death", "color_id"):
        np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    assert tg["occupied"].dtype == jg["occupied"].dtype == bool
    ts, js = t.get_shapes(), j.get_shapes()
    assert [None if s is None else (s.triangles, s.color_id, s.bbox(), len(s)) for s in ts] == \
        [None if s is None else (s.triangles, s.color_id, s.bbox(), len(s)) for s in js]
    assert (t.game_score(), t.current_step, t.get_last_cleared_triangles(), t.is_over(),
            t.get_game_over_reason()) == (j.game_score(), j.current_step,
                                          j.get_last_cleared_triangles(), j.is_over(),
                                          j.get_game_over_reason())
    assert t.valid_actions() == j.valid_actions()
    np.testing.assert_array_equal(t.valid_action_mask(), j.valid_action_mask())


WORLDS = {
    "default": {},
    "tiny": dict(ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
                 MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3),
}


class TestGameState:
    @pytest.mark.parametrize("world, seed", [("default", 0), ("default", 11), ("tiny", 5)])
    def test_trajectory_equals_jax(self, world, seed):
        jcfg = JaxEnvConfig(**WORLDS[world])
        t = GameState(torch_cfg(jcfg), initial_seed=seed, device=CPU)
        j = JaxGameState(jcfg, initial_seed=seed)
        gen = np.random.default_rng(seed)
        _assert_same_game(t, j)
        moves = 0
        while not j.is_over() and moves < 60:
            action = _pick(j.valid_action_mask(), gen)
            assert t.step(action) == j.step(action)
            _assert_same_game(t, j)
            moves += 1
        assert j.is_over() and t.is_over() and moves > 2
        # A forfeit on a finished game changes nothing.
        assert t.step(0) == j.step(0)
        _assert_same_game(t, j)

    def test_copy_forks_and_invalid_forfeits(self):
        jcfg = JaxEnvConfig()
        t = GameState(torch_cfg(jcfg), initial_seed=2, device=CPU)
        j = JaxGameState(jcfg, initial_seed=2)
        tc, jc = t.copy(), j.copy()
        action = t.valid_actions()[0]
        t.step(action)
        j.step(action)
        _assert_same_game(tc, jc)
        assert tc.current_step == 0 and t.current_step == 1
        bad = int(np.flatnonzero(~tc.valid_action_mask())[0])
        assert tc.step(bad) == jc.step(bad) == (jcfg.PENALTY_GAME_OVER, True)
        _assert_same_game(tc, jc)
        assert repr(tc) == repr(jc)

    def test_engine_cache_and_device(self, monkeypatch):
        cfg = tconfig.EnvConfig()
        assert get_env(cfg, CPU) is get_env(tconfig.EnvConfig(), "cpu")
        assert GameState(cfg, device=CPU).device == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GameState(cfg)


class TestFeatures:
    @pytest.mark.parametrize("world", sorted(WORLDS))
    def test_extract_state_features_equals_jax(self, world):
        from alphatriangle_tpu.config import ModelConfig as JaxModelConfig
        from alphatriangle_tpu.config import expected_other_features_dim

        jcfg = JaxEnvConfig(**WORLDS[world])
        jmodel = JaxModelConfig(OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(jcfg))
        t = GameState(torch_cfg(jcfg), initial_seed=4, device=CPU)
        j = JaxGameState(jcfg, initial_seed=4)
        gen = np.random.default_rng(4)
        from alphatriangle_tpu.features.core import get_feature_extractor as jget

        jfe = jget(j._env, jmodel)
        for _ in range(6):
            tf, jf = extract_state_features(t, torch_cfg(jmodel)), jextract(j, jmodel)
            eager = dict(zip(("grid", "other_features"), jfe.extract(j._state)))
            for key in ("grid", "other_features"):
                assert tf[key].dtype == np.float32 and tf[key].shape == jf[key].shape
                np.testing.assert_array_equal(tf[key], np.asarray(eager[key]), err_msg=key)
                np.testing.assert_allclose(tf[key], jf[key], rtol=2.0**-23, atol=0, err_msg=key)
            if j.is_over():
                break
            action = _pick(j.valid_action_mask(), gen)
            t.step(action)
            j.step(action)

    def test_scrub(self, caplog):
        from alphatriangle_tpu_torch.features.extractor import scrub

        x = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
        np.testing.assert_array_equal(scrub("x", x), [1.0, 0.0, 0.0, 0.0])
        assert "Non-finite values in x" in caplog.text


class TestEvaluate:
    @pytest.fixture(scope="class")
    def nets(self):
        jenv = JaxEnvConfig(**WORLDS["tiny"])
        jmodel = small_model_config(jenv)
        jnet = JaxNetwork(jmodel, jenv, seed=3)
        tnet = NeuralNetwork(torch_cfg(jmodel), torch_cfg(jenv), state_dict=converted_state_dict(jnet),
                             device=CPU)
        return jenv, jnet, tnet

    @staticmethod
    def _games(jenv, n: int):
        out = []
        for seed in range(n):
            t = GameState(torch_cfg(jenv), initial_seed=seed, device=CPU)
            j = JaxGameState(jenv, initial_seed=seed)
            gen = np.random.default_rng(seed)
            for _ in range(seed):
                action = _pick(j.valid_action_mask(), gen)
                t.step(action)
                j.step(action)
            out.append((t, j))
        return out

    @staticmethod
    def _close(got, want) -> None:
        (tp, tv), (jp, jv) = got, want
        assert sorted(tp) == sorted(jp) == list(range(len(jp)))
        np.testing.assert_allclose([tp[a] for a in sorted(tp)], [jp[a] for a in sorted(jp)],
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tv, jv, rtol=F32_TOL, atol=F32_TOL)

    def test_evaluate_state_equals_jax(self, nets):
        jenv, jnet, tnet = nets
        for t, j in self._games(jenv, 3):
            got = tnet.evaluate_state(t)
            self._close(got, jnet.evaluate_state(j))
            assert abs(sum(got[0].values()) - 1.0) < 1e-5

    @pytest.mark.parametrize("n", [1, 3, 5])
    def test_evaluate_batch_equals_jax_and_single_states(self, nets, n):
        jenv, jnet, tnet = nets
        games = self._games(jenv, n)
        got = tnet.evaluate_batch([t for t, _ in games])
        want = jnet.evaluate_batch([j for _, j in games])
        assert len(got) == len(want) == n
        for (t, _), g, w in zip(games, got, want):
            self._close(g, w)
            self._close(g, tnet.evaluate_state(t))
        assert tnet.evaluate_batch([]) == []

    def test_normalize_policy_falls_back_to_uniform(self, nets):
        jenv, jnet, tnet = nets
        (t, j), = self._games(jenv, 1)
        for probs in (np.zeros(jenv.action_dim), np.full(jenv.action_dim, 2.0 / jenv.action_dim),
                      np.full(jenv.action_dim, 1.0 / jenv.action_dim)):
            np.testing.assert_array_equal(tnet._normalize_policy(probs.copy(), t, "x"),
                                          jnet._normalize_policy(probs.copy(), j, "x"))


@needs_gxx
class TestNative:
    @pytest.fixture(scope="class")
    def world(self):
        jcfg = JaxEnvConfig(ROWS=4, COLS=6, PLAYABLE_RANGE_PER_ROW=[(0, 6), (1, 5), (0, 6), (0, 6)],
                            NUM_SHAPE_SLOTS=2)
        from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv

        jenv, tenv = JaxEnv(jcfg), TriangleEnv(torch_cfg(jcfg), device=CPU)
        return jenv, tenv, jnative.NativeTriangleEnv(jenv), tnative.NativeTriangleEnv(tenv)

    def test_builds_into_the_build_directory(self):
        assert tnative.native_available(), tnative.native_build_error()
        lib = tnative.library_path()
        assert lib.exists() and lib.parent.name == "_build"
        assert lib.parent.parent.name == "alphatriangle_tpu_torch"
        assert not list((lib.parent.parent / "env" / "native").glob("*.so"))

    def test_equals_the_jax_native_engine(self, world):
        """Both libraries from one batch seed and the same actions, refills
        included (both draw them from xorshift): every array equal."""
        _, _, jn, tn = world
        jb, tb = jn.new_batch(16, seed=3), tn.new_batch(16, seed=3)
        gen = np.random.default_rng(0)
        for _ in range(12):
            jmask, tmask = jn.valid_mask(jb), tn.valid_mask(tb)
            np.testing.assert_array_equal(tmask, jmask)
            actions = np.array([_pick(m, gen) for m in jmask], np.int32)
            jr, jd = jn.step(jb, actions)
            tr, td = tn.step(tb, actions)
            np.testing.assert_array_equal(tr, jr)
            for name in ("occupied", "color", "shape_idx", "shape_color", "rng", "done", "score",
                         "step_count", "last_cleared"):
                np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)

    def test_refill_free_transitions_equal_the_tensor_engine(self, world):
        """Mid-game states of the port's engine copied into a native batch:
        the masks, and one step whose hand keeps a shape (no refill), agree
        on every field; where the tensor engine refilled, on the board,
        the reward and the score."""
        _, tenv, _, tn = world
        n = 32
        gen = np.random.default_rng(7)
        states = tenv.reset(rng.split(rng.PRNGKey(2), n))
        checked = 0
        for _ in range(10):
            masks = tenv.valid_action_mask(states).numpy()
            batch = tn.new_batch(n)
            batch.occupied[:] = states.occupied.numpy().astype(np.uint32)
            batch.color[:] = states.color.numpy().reshape(n, -1)
            batch.shape_idx[:] = states.shape_idx.numpy()
            batch.shape_color[:] = states.shape_color.numpy()
            batch.score[:] = states.score.numpy()
            batch.step_count[:] = states.step_count.numpy()
            batch.done[:] = states.done.numpy().astype(np.uint8)
            batch.last_cleared[:] = states.last_cleared.numpy()
            np.testing.assert_array_equal(tn.valid_mask(batch), masks)
            actions = np.array([_pick(m, gen) for m in masks], np.int32)
            will_refill = (states.shape_idx.numpy() >= 0).sum(axis=1) == 1
            keep = ~will_refill | states.done.numpy()
            rewards, done = tn.step(batch, actions, refill=False)
            states, treward, tdone = tenv.step(states, torch.from_numpy(actions))
            np.testing.assert_array_equal(batch.occupied, states.occupied.numpy().astype(np.uint32))
            np.testing.assert_array_equal(batch.color.reshape(n, tenv.rows, tenv.cols),
                                          states.color.numpy())
            np.testing.assert_allclose(batch.score, states.score.numpy(), rtol=1e-6)
            np.testing.assert_array_equal(batch.step_count, states.step_count.numpy())
            np.testing.assert_array_equal(batch.last_cleared, states.last_cleared.numpy())
            # Where the tensor engine refilled, its new hand can unstick
            # what the empty native hand calls stuck (reward and done).
            np.testing.assert_allclose(rewards[keep], treward.numpy()[keep], rtol=1e-6)
            np.testing.assert_array_equal(done[keep].astype(bool), tdone.numpy()[keep])
            np.testing.assert_array_equal(batch.shape_idx[keep], states.shape_idx.numpy()[keep])
            for g in np.flatnonzero(~keep):
                assert (batch.shape_idx[g] < 0).all()
            checked += int(keep.sum())
            if states.done.all():
                break
        assert checked > n

    def test_unpack_grid_np(self, world):
        jenv, tenv, _, _ = world
        words = np.array([0xDEADBEEF], np.uint32)
        np.testing.assert_array_equal(tenv.unpack_grid_np(words), jenv.unpack_grid_np(words))


SCRIPT = "0 3 3;v;1 3 5;x;9 9 9;2 4 6;0 2 2;0 4 8;1 5 3;2 5 9;v"


def _transcript(mod, argv, capsys) -> tuple:
    rc = mod.main(["play", *argv])
    return rc, capsys.readouterr().out.splitlines()


class TestCliPlay:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_torch_engine_transcript_equals_jax(self, seed, capsys):
        script = self._valid_script(seed)
        jrc, jout = _transcript(jcli, ["--engine", "jax", "--seed", str(seed), "--script", script],
                                capsys)
        trc, tout = _transcript(cli, ["--engine", "jax", "--device", "cpu", "--seed", str(seed),
                                      "--script", script], capsys)
        assert trc == jrc == 0
        assert tout[0] == jout[0].replace("engine=jax", "engine=torch")
        assert tout[1:] == jout[1:]
        assert sum(line.startswith("reward ") for line in tout) >= 3

    @needs_gxx
    @pytest.mark.parametrize("engine", ["native", "auto"])
    def test_native_transcript_equals_jax(self, engine, capsys):
        jrc, jout = _transcript(jcli, ["--engine", engine, "--seed", "3", "--script", SCRIPT], capsys)
        trc, tout = _transcript(cli, ["--engine", engine, "--seed", "3", "--script", SCRIPT], capsys)
        assert trc == jrc == 0 and tout == jout
        assert "engine=native" in tout[0] and "Expected: SLOT ROW COL" in tout
        assert "Out of range." in tout and any(line.startswith("reward ") for line in tout)

    def test_game_over_and_quit(self, capsys):
        """A script that plays a game to its end prints GAME OVER as JAX's
        does; 'q' quits."""
        jcfg = JaxEnvConfig()
        j = JaxGameState(jcfg, initial_seed=9)
        moves = []
        while not j.is_over():
            a = j.valid_actions()[-1]
            moves.append(a)
            j.step(a)
        cells = jcfg.ROWS * jcfg.COLS
        script = ";".join(f"{a // cells} {(a % cells) // jcfg.COLS} {a % jcfg.COLS}" for a in moves)
        for extra in (script, "q"):
            jrc, jout = _transcript(jcli, ["--engine", "jax", "--seed", "9", "--script", extra], capsys)
            trc, tout = _transcript(cli, ["--engine", "jax", "--device", "cpu", "--seed", "9",
                                          "--script", extra], capsys)
            assert trc == jrc == 0 and tout[1:] == jout[1:]
        assert "GAME OVER." in _transcript(cli, ["--engine", "jax", "--device", "cpu", "--seed", "9",
                                                 "--script", script], capsys)[1]

    def test_jax_engine_needs_a_card_unless_told_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["play", "--engine", "jax", "--script", "q"])

    @staticmethod
    def _valid_script(seed: int) -> str:
        """Three legal moves of the seed's game, with a 'v' and a bad move
        between them."""
        jcfg = JaxEnvConfig()
        j = JaxGameState(jcfg, initial_seed=seed)
        cells = jcfg.ROWS * jcfg.COLS
        lines = []
        for _ in range(3):
            a = j.valid_actions()[len(j.valid_actions()) // 2]
            lines += [f"{a // cells} {(a % cells) // jcfg.COLS} {a % jcfg.COLS}", "v", "0 0 0"]
            j.step(a)
        return ";".join(lines)


def test_render_equals_jax():
    gen = np.random.default_rng(0)
    occ, death = gen.random((5, 7)) < 0.5, gen.random((5, 7)) < 0.2
    assert render_grid(occ, death) == jrender_grid(occ, death)
    for tris in ([], [(0, 0, True), (0, 1, False), (1, 1, True)], [(2, 3, False)]):
        assert render_shape(tris) == jrender_shape(tris)


@pytest.mark.parametrize("point", [(1, 1), (0, 0), (2, 1), (3, 3), (1, 2), (-1, 0), (0.5, 2)])
def test_point_in_polygon_equals_jax(point):
    for poly in ([(0, 0), (2, 0), (2, 2), (0, 2)], [(0, 0), (4, 0), (2, 3)], [(0, 0), (1, 1)]):
        assert is_point_in_polygon(point, poly) == jinside(point, poly)


def test_app_name():
    from alphatriangle_tpu_torch.config.persistence_config import PersistenceConfig

    assert tconfig.APP_NAME == PersistenceConfig().APP_NAME == "AlphaTriangleTPUTorch"
    assert jnp is not None and jax is not None
