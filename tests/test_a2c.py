"""A2C learner: loss math, single-device iteration, sharded iteration."""

import jax
import jax.numpy as jnp
import numpy as np

from gym_futbol_tpu import EnvParams
from gym_futbol_tpu import a2c
from gym_futbol_tpu.models.policy import ActorCritic
from gym_futbol_tpu.parallel import (
    make_mesh,
    shard_env_state,
    shard_train_iteration,
)

P = EnvParams(players_per_team=1, substeps=2, solver_iterations=3, max_steps=32)
CFG = a2c.A2CConfig(rollout_steps=4)


def _setup(n_envs=16):
    model = ActorCritic(n_players=P.players_per_team, hidden=(32,))
    tx = a2c.make_optimizer(CFG)
    runner = a2c.init_runner(
        jax.random.PRNGKey(0), model, P, CFG, n_envs=n_envs, tx=tx
    )
    return model, tx, runner


class TestA2C:
    def test_iteration_runs_and_updates(self, key):
        model, tx, runner = _setup()
        step = jax.jit(
            lambda r: a2c.train_iteration(r, model, P, CFG, tx)
        )
        r2, metrics = step(runner)
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["mean_reward"]))
        # params actually changed
        leaves0 = jax.tree.leaves(runner.params)
        leaves1 = jax.tree.leaves(r2.params)
        assert any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(leaves0, leaves1)
        )

    def test_loss_gradient_direction(self):
        """Positive-advantage actions get more probable after one step on a
        fixed batch (policy-gradient sign check)."""
        model, tx, runner = _setup()
        runner, traj, last_v = a2c.collect_rollout(runner, model, P, CFG)
        adv, ret = a2c.compute_gae(traj, last_v, CFG)
        n = traj.reward.shape[0] * traj.reward.shape[1]
        flat = jax.tree.map(lambda x: x.reshape((n,) + x.shape[2:]), traj)
        adv_pos = jnp.ones((n,))  # force positive advantage everywhere
        grads, _ = jax.grad(a2c.a2c_loss, has_aux=True)(
            runner.params, model, flat, adv_pos, ret.reshape(n), CFG
        )
        updates, _ = tx.update(grads, tx.init(runner.params), runner.params)
        import optax
        new_params = optax.apply_updates(runner.params, updates)

        from gym_futbol_tpu.models.policy import (
            action_log_prob_and_entropy_packed,
        )
        logits0, _ = model.apply(runner.params, flat.obs)
        logits1, _ = model.apply(new_params, flat.obs)
        lp0, _ = action_log_prob_and_entropy_packed(logits0, flat.dirs, flat.acts)
        lp1, _ = action_log_prob_and_entropy_packed(logits1, flat.dirs, flat.acts)
        assert float((lp1 - lp0).mean()) > 0.0

    def test_sharded_iteration(self, key):
        model, tx, runner = _setup(n_envs=16)
        mesh = make_mesh()
        runner = runner.replace(env_state=shard_env_state(runner.env_state, mesh))
        step = shard_train_iteration(
            mesh, model, P, CFG, tx, iteration_fn=a2c.train_iteration
        )
        r2, metrics = step(runner)
        assert np.isfinite(float(metrics["loss"]))
        # params stay replicated across shards
        p0 = jax.tree.leaves(r2.params)[0]
        assert p0.sharding.is_fully_replicated
