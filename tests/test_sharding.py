"""Multi-device tests on the fake 8-device CPU mesh (SURVEY.md §4.2 item 4;
BASELINE configs 4-5 logic). These exercise the same code paths that run on
several GPUs — shard_map semantics are device-count agnostic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_futbol_tpu import EnvParams
from gym_futbol_tpu.models.policy import ActorCritic
from gym_futbol_tpu.parallel import (
    env_sharding,
    make_mesh,
    shard_env_state,
    shard_rollout,
    shard_train_iteration,
)
from gym_futbol_tpu.ppo import PPOConfig, init_runner, make_optimizer
from gym_futbol_tpu.vector import reset_batch


P = EnvParams(players_per_team=2)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest must force 8 fake CPU devices"
    return make_mesh()


class TestShardedRollout:
    def test_rollout_sharded_over_env(self, mesh, key):
        n, t = 64, 20
        state, _ = reset_batch(key, P, n)
        state = shard_env_state(state, mesh)
        assert state.pos.sharding.is_equivalent_to(env_sharding(mesh), 3)

        run = shard_rollout(mesh, P, t)
        state, outs = run(state, jax.random.PRNGKey(1))
        assert outs.reward.shape == (t, n)
        assert np.isfinite(np.asarray(outs.reward)).all()

    def test_sharded_matches_single_device(self, mesh, key):
        """The sharded rollout must be bitwise-identical in semantics to the
        unsharded one (pure SPMD, no collectives in the env step)."""
        from gym_futbol_tpu.vector import random_policy, rollout

        n, t = 16, 10
        state, _ = reset_batch(key, P, n)
        policy = random_policy(P)
        k = jax.random.PRNGKey(1)
        _, outs_ref = rollout(state, policy, k, P, t)

        state2, _ = reset_batch(key, P, n)
        state2 = shard_env_state(state2, mesh)
        run = shard_rollout(mesh, P, t)
        _, outs_sh = run(state2, k)
        np.testing.assert_array_equal(
            np.asarray(outs_ref.reward), np.asarray(outs_sh.reward)
        )
        np.testing.assert_array_equal(
            np.asarray(outs_ref.obs), np.asarray(outs_sh.obs)
        )


class TestShardedTraining:
    def test_train_iteration_runs_and_keeps_params_replicated(self, mesh, key):
        env_params = EnvParams(players_per_team=1, max_steps=32)
        cfg = PPOConfig(rollout_steps=8, epochs=1, minibatches=2)
        model = ActorCritic(n_players=env_params.players_per_team, hidden=(32,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, env_params, cfg, n_envs=16, tx=tx)
        runner = runner.replace(env_state=shard_env_state(runner.env_state, mesh))

        step_fn = shard_train_iteration(mesh, model, env_params, cfg, tx)
        runner, metrics = step_fn(runner)
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["mean_reward"]))

        # params must be fully replicated (identical on all shards)
        leaves = jax.tree.leaves(runner.params)
        for leaf in leaves:
            assert leaf.sharding.is_fully_replicated
        runner, metrics2 = step_fn(runner)
        assert np.isfinite(float(metrics2["loss"]))

    def test_normalized_training_global_stats(self, mesh, key):
        """VecNormalize wired through sharded PPO (VERDICT r2 item 4):
        the running obs-normalizer must be GLOBAL — its sample count
        after K iterations equals K * T * 2B_global (a per-shard
        normalizer would count only 2B_local per step), its stats must be
        replicated across shards, and eval uses frozen stats."""
        import functools

        from gym_futbol_tpu.parallel import ppo_runner_specs
        from gym_futbol_tpu.parallel.mesh import ENV_AXIS
        from gym_futbol_tpu.ppo import make_normalized_collect, train_iteration

        env_params = EnvParams(players_per_team=1, max_steps=32)
        cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
        model = ActorCritic(n_players=env_params.players_per_team,
                            hidden=(16,))
        tx = make_optimizer(cfg)
        n_envs = 16
        runner = init_runner(key, model, env_params, cfg, n_envs=n_envs,
                             tx=tx, normalize_obs=True,
                             normalize_reward=True)
        runner = runner.replace(
            env_state=shard_env_state(runner.env_state, mesh))
        step_fn = shard_train_iteration(
            mesh, model, env_params, cfg, tx,
            iteration_fn=functools.partial(
                train_iteration,
                collect_fn=make_normalized_collect(
                    True, True, axis_name=ENV_AXIS),
            ),
            runner_specs=ppo_runner_specs(True, True),
        )
        iters = 2
        for _ in range(iters):
            runner, metrics = step_fn(runner)
        assert np.isfinite(float(metrics["loss"]))
        # global count: both self-play views of the GLOBAL batch per step
        expected = iters * cfg.rollout_steps * 2 * n_envs
        assert abs(float(runner.obs_norm.count) - expected) < 1.0
        assert runner.obs_norm.mean.sharding.is_fully_replicated
        assert runner.rew_norm.var.sharding.is_fully_replicated
        assert np.isfinite(np.asarray(runner.obs_norm.mean)).all()
        assert float(runner.rew_norm.var) > 0
        # reward-return accumulator stays with its envs
        assert runner.rew_norm.ret.shape == (n_envs,)

        # eval path: frozen stats, no update
        from gym_futbol_tpu.evaluate import evaluate
        from gym_futbol_tpu.models.policy import make_normalized_policy_fn

        count_before = float(runner.obs_norm.count)
        policy = make_normalized_policy_fn(model, runner.params,
                                           runner.obs_norm)
        res = evaluate(env_params, policy_a=policy, n_envs=8, n_steps=8)
        assert np.isfinite(res["mean_team0_reward"])
        assert float(runner.obs_norm.count) == count_before

    def test_learning_signal_exists(self, mesh, key):
        """Loss changes across iterations — the update actually applies."""
        env_params = EnvParams(players_per_team=1, max_steps=32)
        cfg = PPOConfig(rollout_steps=8, epochs=1, minibatches=2, lr=1e-2)
        model = ActorCritic(n_players=env_params.players_per_team, hidden=(32,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, env_params, cfg, n_envs=16, tx=tx)
        runner = runner.replace(env_state=shard_env_state(runner.env_state, mesh))
        step_fn = shard_train_iteration(mesh, model, env_params, cfg, tx)

        p0 = jax.tree.leaves(runner.params)[0].copy()
        runner, _ = step_fn(runner)
        p1 = jax.tree.leaves(runner.params)[0]
        assert not np.allclose(np.asarray(p0), np.asarray(p1))


class TestFourDeviceEmulation:
    """The one-device reference of the sharded iteration
    (parallel.emulate_sharded_iteration) that chip_smoke.py --four-gpus
    compares 4 GPUs against."""

    def _setup(self):
        from gym_futbol_tpu.parallel import emulate_sharded_iteration

        env_params = EnvParams(players_per_team=2, max_steps=16)
        cfg = PPOConfig(rollout_steps=4, epochs=2, minibatches=2,
                        shuffle_block=8)
        model = ActorCritic(n_players=2, hidden=(16,))
        tx = make_optimizer(cfg)
        make = lambda: init_runner(jax.random.PRNGKey(0), model, env_params,
                                   cfg, n_envs=64, tx=tx)
        emu = emulate_sharded_iteration(4, model, env_params, cfg, tx)
        return env_params, cfg, model, tx, make, emu

    def test_emulation_matches_sharded_iteration(self):
        from gym_futbol_tpu.parallel import shard_runner

        env_params, cfg, model, tx, make, emu = self._setup()
        mesh = make_mesh(jax.devices()[:4])
        fn = shard_train_iteration(mesh, model, env_params, cfg, tx)
        r4, r1 = shard_runner(make(), mesh), make()
        for _ in range(2):
            r4, m4 = fn(r4)
            r1, m1 = emu(r1)
            np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                                       rtol=1e-5, atol=1e-6)
        for a, b in zip(jax.tree.leaves(r4.params), jax.tree.leaves(r1.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(r4.env_state.pos),
                                      np.asarray(r1.env_state.pos))

    @pytest.mark.parametrize("n_dev", [1, 4])
    def test_placed_runner_compiles_once(self, n_dev):
        from gym_futbol_tpu.parallel import shard_runner

        env_params, cfg, model, tx, make, _ = self._setup()
        mesh = make_mesh(jax.devices()[:n_dev])
        fn = shard_train_iteration(mesh, model, env_params, cfg, tx)
        r = shard_runner(make(), mesh)
        for _ in range(3):
            r, _ = fn(r)
        assert fn._cache_size() == 1
