"""Checkpoint round-trip, metrics writer, profiling helpers (SURVEY.md §5)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from gym_futbol_tpu import EnvParams
from gym_futbol_tpu.models.policy import ActorCritic
from gym_futbol_tpu.ppo import PPOConfig, init_runner, make_optimizer
from gym_futbol_tpu.utils.checkpoint import Checkpointer
from gym_futbol_tpu.utils.metrics import MetricsLogger
from gym_futbol_tpu.utils.profiling import cost_analysis, timed


class TestCheckpoint:
    def test_runner_roundtrip(self, key, tmp_path):
        p = EnvParams(players_per_team=1, max_steps=10)
        cfg = PPOConfig(rollout_steps=4, minibatches=2)
        model = ActorCritic(n_players=p.players_per_team, hidden=(16,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, p, cfg, n_envs=4, tx=tx)

        ck = Checkpointer(str(tmp_path / "ckpt"))
        ck.save(runner, step=7)
        ck.wait()

        restored, step = ck.restore_latest(runner)
        assert step == 7
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)
            ),
            runner, restored,
        )

    def test_restore_empty_dir(self, key, tmp_path):
        ck = Checkpointer(str(tmp_path / "none"))
        restored, step = ck.restore_latest({"x": jnp.zeros(3)})
        assert restored is None and step == 0


class TestMetrics:
    def test_jsonl_written(self, tmp_path):
        log = MetricsLogger(str(tmp_path), tensorboard=False)
        rec = log.write(3, {"loss": jnp.asarray(1.5), "n": 2})
        log.close()
        assert rec["loss"] == 1.5
        lines = open(os.path.join(tmp_path, "metrics.jsonl")).readlines()
        parsed = json.loads(lines[-1])
        assert parsed["step"] == 3 and parsed["loss"] == 1.5

    def test_no_directory_is_noop(self):
        log = MetricsLogger(None)
        rec = log.write(0, {"a": 1.0})
        assert rec["a"] == 1.0
        log.close()


class TestProfiling:
    def test_timed(self):
        x = jnp.ones((8, 8))
        with timed("matmul", sync=x) as t:
            y = x @ x
        assert t["seconds"] is not None and t["seconds"] >= 0

    def test_cost_analysis_has_flops(self):
        out = cost_analysis(lambda a: a @ a, jnp.ones((64, 64)))
        assert isinstance(out, dict)


class TestCheckpointFidelity:
    """Resume fidelity (VERDICT r3 item 7): a run interrupted MID-EPISODE
    and restored from checkpoint must continue BITWISE identically to the
    uninterrupted run — including VecNormalize stats and the recurrent
    carry — proving the 'resumes mid-episode' claim of
    utils/checkpoint.py, not just the array round-trip."""

    def _bitwise_equal(self, a, b):
        jax.tree.map(
            lambda x, y: np.testing.assert_array_equal(
                np.asarray(x), np.asarray(y)
            ),
            a, b,
        )

    def test_ppo_normalized_resume_bitwise(self, key, tmp_path):
        from gym_futbol_tpu.ppo import (
            make_normalized_collect, train_iteration,
        )

        p = EnvParams(players_per_team=1, max_steps=9)  # 9 > 2*4 steps:
        # episodes straddle the checkpoint boundary (mid-episode resume)
        cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1)
        model = ActorCritic(n_players=p.players_per_team, hidden=(16,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, p, cfg, n_envs=4, tx=tx,
                             normalize_obs=True, normalize_reward=True)
        step = jax.jit(lambda r: train_iteration(
            r, model, p, cfg, tx,
            collect_fn=make_normalized_collect(),
        ))

        # uninterrupted: 3 iterations
        r_ref = runner
        for _ in range(3):
            r_ref, _ = step(r_ref)

        # interrupted: 2 iterations, checkpoint, restore, 1 more
        r_a = runner
        for _ in range(2):
            r_a, _ = step(r_a)
        assert int(jax.device_get(r_a.env_state.t).max()) not in (0,), (
            "test must checkpoint mid-episode"
        )
        ck = Checkpointer(str(tmp_path / "ppo"))
        ck.save(r_a, step=2)
        ck.wait()
        restored, it = ck.restore_latest(r_a)
        assert it == 2
        self._bitwise_equal(r_a, restored)
        r_b, _ = step(restored)
        r_ref_like = jax.device_get(r_ref)
        self._bitwise_equal(jax.device_get(r_b), r_ref_like)

    def test_recurrent_resume_bitwise(self, key, tmp_path):
        from gym_futbol_tpu import a2c
        from gym_futbol_tpu.models.recurrent import RecurrentActorCritic

        p = EnvParams(players_per_team=1, max_steps=7)
        cfg = a2c.A2CConfig(rollout_steps=3)
        model = RecurrentActorCritic(
            n_players=p.players_per_team, hidden=(16,), lstm_size=8
        )
        tx = a2c.make_optimizer(cfg)
        runner = a2c.init_recurrent_runner(
            key, model, p, cfg, n_envs=4, tx=tx
        )
        step = jax.jit(lambda r: a2c.train_iteration_recurrent(
            r, model, p, cfg, tx
        ))

        r_ref = runner
        for _ in range(3):
            r_ref, _ = step(r_ref)

        r_a = runner
        for _ in range(2):
            r_a, _ = step(r_a)
        # the LSTM carry is live state: assert it is nonzero somewhere so
        # the bitwise check below is meaningful
        assert any(
            float(jnp.abs(c).max()) > 0
            for c in jax.tree.leaves(r_a.carry)
        )
        ck = Checkpointer(str(tmp_path / "rec"))
        ck.save(r_a, step=2)
        ck.wait()
        restored, it = ck.restore_latest(r_a)
        assert it == 2
        self._bitwise_equal(r_a, restored)
        r_b, _ = step(restored)
        self._bitwise_equal(jax.device_get(r_b), jax.device_get(r_ref))


class TestCompileCache:
    def test_env_dir_is_honoured(self, monkeypatch, tmp_path):
        from gym_futbol_tpu.utils import cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets no directory
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_dir_is_fixed_in_checkout(self, monkeypatch):
        from gym_futbol_tpu.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
        assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
        assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR


def test_main_path_imports_without_flax(tmp_path):
    """The package, the trainer, the benchmark and the smoke test import
    with flax unavailable (it is not installed beside JAX everywhere)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import gym_futbol_tpu, gym_futbol_tpu.train, gym_futbol_tpu.ppo\n"
        "import gym_futbol_tpu.a2c, gym_futbol_tpu.recurrent_ppo\n"
        "import gym_futbol_tpu.evaluate, gym_futbol_tpu.wrappers\n"
        "import gym_futbol_tpu.models.recurrent, gym_futbol_tpu.ops\n"
        "import gym_futbol_tpu.parallel, bench, chip_smoke\n"
        "from gym_futbol_tpu.utils.metrics import MetricsLogger\n"
        f"MetricsLogger({str(tmp_path)!r}).write(0, {{'x': 1}})\n"
        "print('imported')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "imported" in proc.stdout
