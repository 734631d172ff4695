"""A2C learner, fully on-device.

The reference's training scripts use stable-baselines ``PPO2``/``A2C``
(SURVEY.md §2.1 #12, §3.5). :mod:`gym_futbol_tpu.ppo` covers PPO; this
module is the synchronous advantage actor-critic companion: one shared
self-play rollout (reused from ppo.collect_rollout — per-team policy,
both perspectives in the buffer), n-step/GAE targets, and a SINGLE
full-batch gradient step per iteration — no clipping, no minibatch
epochs. Classic A2C uses RMSProp (the stable-baselines
default); :func:`make_optimizer` follows that.

Like PPO, the whole iteration is one pure jittable function, and the
sharded path reuses :func:`gym_futbol_tpu.parallel.shard_iteration`
with gradients pmean'd over the 'env' mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from . import pytree
from .models.policy import (
    ActorCritic,
    action_log_prob_and_entropy_packed,
    pack_actions,
    sample_actions,
)
from .ppo import (
    RunnerState,
    Transition,
    _both_views,
    collect_rollout,
    compute_gae,
    init_runner,
)
from .types import EnvParams


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    rollout_steps: int = 8
    gamma: float = 0.99
    gae_lambda: float = 1.0      # 1.0 => plain n-step advantage (classic A2C)
    lr: float = 7e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    rms_decay: float = 0.99
    rms_eps: float = 1e-5


def make_optimizer(cfg: A2CConfig) -> optax.GradientTransformation:
    """RMSProp, the stable-baselines A2C default."""
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.rmsprop(cfg.lr, decay=cfg.rms_decay, eps=cfg.rms_eps),
    )


def a2c_loss(
    params, model: ActorCritic, traj, adv: jax.Array, returns: jax.Array,
    cfg: A2CConfig,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Vanilla actor-critic loss on the full [T*B] batch."""
    logits, value = model.apply(params, traj.obs)
    logp, entropy = action_log_prob_and_entropy_packed(
        logits, traj.dirs, traj.acts
    )
    pg_loss = -(jax.lax.stop_gradient(adv) * logp).mean()
    v_loss = 0.5 * ((value - returns) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
    }


def train_iteration(
    runner: RunnerState, model: ActorCritic, env_params: EnvParams,
    cfg: A2CConfig, tx, axis_name: str | None = None,
) -> tuple[RunnerState, dict[str, jax.Array]]:
    """One A2C iteration: rollout -> advantages -> one gradient step.

    Pure and jittable; drop-in signature-compatible with
    :func:`gym_futbol_tpu.ppo.train_iteration` so the sharding layer and
    the training CLI treat both algorithms uniformly.
    """
    runner, traj, last_value = collect_rollout(runner, model, env_params, cfg)
    adv, returns = compute_gae(traj, last_value, cfg)

    n = traj.reward.shape[0] * traj.reward.shape[1]
    flat = jax.tree.map(lambda x: x.reshape((n,) + x.shape[2:]), traj)
    grads, metrics = jax.grad(a2c_loss, has_aux=True)(
        runner.params, model, flat, adv.reshape(n), returns.reshape(n), cfg,
    )
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        metrics = jax.lax.pmean(metrics, axis_name)
    updates, opt_state = tx.update(grads, runner.opt_state, runner.params)
    params = optax.apply_updates(runner.params, updates)

    # team-0 perspective rows only (self-play buffer layout; see ppo.py)
    metrics["mean_reward"] = traj.reward[
        :, : traj.reward.shape[1] // 2
    ].mean()
    if axis_name is not None:
        metrics["mean_reward"] = jax.lax.pmean(metrics["mean_reward"], axis_name)
    return runner.replace(params=params, opt_state=opt_state), metrics


# ---------------------------------------------------------------------------
# Recurrent (LSTM) A2C — the stable-baselines MlpLstmPolicy analog
# (SURVEY.md §3.5). Full-batch updates keep sequences intact: the loss
# recomputes the forward pass through time from the rollout's initial
# carry (BPTT over the whole [T] window), resetting at episode bounds.
# ---------------------------------------------------------------------------


@pytree.dataclass
class RecurrentRunnerState:
    params: Any
    opt_state: Any
    env_state: Any        # batched EnvState
    obs: jax.Array        # [B, obs_dim]
    carry: Any            # LSTM (c, h), each [2, B, lstm] (view-major so
                          # the 'env' mesh axis shards dim 1, keeping each
                          # device's two perspective blocks local)
    key: jax.Array


def init_recurrent_runner(
    key: jax.Array, model, env_params: EnvParams, cfg: A2CConfig,
    n_envs: int, tx,
) -> RecurrentRunnerState:
    from .models.recurrent import init_recurrent_params
    from .vector import reset_batch

    k_params, k_env, k_run = jax.random.split(key, 3)
    params = init_recurrent_params(k_params, model, env_params, batch_size=1)
    opt_state = tx.init(params)
    env_state, obs = reset_batch(k_env, env_params, n_envs)
    carry = jax.tree.map(
        lambda c: jnp.broadcast_to(c, (2, n_envs) + c.shape[1:]),
        model.initial_carry(n_envs),
    )
    return RecurrentRunnerState(
        params=params, opt_state=opt_state, env_state=env_state, obs=obs,
        carry=carry, key=k_run,
    )


def _flat_carry(carry, b: int):
    return jax.tree.map(lambda c: c.reshape((2 * b,) + c.shape[2:]), carry)


def collect_recurrent_rollout(
    runner: RecurrentRunnerState, model, env_params: EnvParams,
    cfg: A2CConfig,
) -> tuple[RecurrentRunnerState, Transition, jax.Array]:
    """Self-play recurrent rollout (same perspective layout as
    ppo.collect_rollout: rows [:B] team 0, [B:] team 1 mirrored); the
    LSTM carry is per perspective and zeroed where an episode ends."""
    from . import env as env_core
    from .models.recurrent import reset_carry_where_done
    from .vector import step_batch

    assert model.n_players == env_params.players_per_team
    b = runner.obs.shape[0]

    def body(c, _):
        env_state, obs, carry, key = c
        key, k_act = jax.random.split(key)
        obs2 = _both_views(obs, env_params)
        carry, (logits, value) = model.apply(runner.params, carry, obs2)
        action2, logp = sample_actions(k_act, logits)
        joint = jnp.concatenate(
            [action2[:b], env_core.mirror_actions(action2[b:])], axis=1
        )
        env_state, out = step_batch(env_state, joint, env_params)
        done2 = jnp.concatenate([out.done, out.done], axis=0)
        carry = reset_carry_where_done(carry, done2)
        dirs, acts = pack_actions(action2)
        tr = Transition(
            obs=obs2, dirs=dirs, acts=acts, logp=logp, value=value,
            reward=jnp.concatenate(
                [out.team_reward[:, 0], out.team_reward[:, 1]], axis=0
            ),
            done=done2,
        )
        return (env_state, out.obs, carry, key), tr

    (env_state, obs, carry, key), traj = jax.lax.scan(
        body,
        (runner.env_state, runner.obs, _flat_carry(runner.carry, b),
         runner.key),
        None, length=cfg.rollout_steps,
    )
    _, (_, last_value) = model.apply(
        runner.params, carry, _both_views(obs, env_params)
    )
    carry = jax.tree.map(
        lambda c: c.reshape((2, b) + c.shape[1:]), carry
    )
    runner = runner.replace(
        env_state=env_state, obs=obs, carry=carry, key=key
    )
    return runner, traj, last_value


def recurrent_a2c_loss(
    params, model, traj: Transition, init_carry, adv, returns,
    cfg: A2CConfig,
):
    """BPTT loss: re-run the LSTM over the whole window from the
    rollout's initial carry (resetting at dones) so gradients flow
    through time."""
    from .models.recurrent import reset_carry_where_done

    def body(c, tr):
        c, (logits, value) = model.apply(params, c, tr.obs)
        logp, ent = action_log_prob_and_entropy_packed(
            logits, tr.dirs, tr.acts
        )
        c = reset_carry_where_done(c, tr.done)
        return c, (logp, ent, value)

    _, (logp, ent, value) = jax.lax.scan(body, init_carry, traj)
    pg_loss = -(jax.lax.stop_gradient(adv) * logp).mean()
    v_loss = 0.5 * ((value - returns) ** 2).mean()
    e = ent.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * e
    return total, {
        "loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": e,
    }


def train_iteration_recurrent(
    runner: RecurrentRunnerState, model, env_params: EnvParams,
    cfg: A2CConfig, tx, axis_name: str | None = None,
) -> tuple[RecurrentRunnerState, dict[str, jax.Array]]:
    """One recurrent A2C iteration. Signature-compatible with the
    sharding layer (pass ``runner_specs=recurrent_runner_specs()`` to
    :func:`gym_futbol_tpu.parallel.shard_train_iteration`)."""
    b = runner.obs.shape[0]
    init_carry = _flat_carry(runner.carry, b)
    runner, traj, last_value = collect_recurrent_rollout(
        runner, model, env_params, cfg
    )
    adv, returns = compute_gae(traj, last_value, cfg)
    grads, metrics = jax.grad(recurrent_a2c_loss, has_aux=True)(
        runner.params, model, traj, init_carry, adv, returns, cfg
    )
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        metrics = jax.lax.pmean(metrics, axis_name)
    updates, opt_state = tx.update(grads, runner.opt_state, runner.params)
    params = optax.apply_updates(runner.params, updates)
    metrics["mean_reward"] = traj.reward[
        :, : traj.reward.shape[1] // 2
    ].mean()
    if axis_name is not None:
        metrics["mean_reward"] = jax.lax.pmean(
            metrics["mean_reward"], axis_name
        )
    return runner.replace(params=params, opt_state=opt_state), metrics


def recurrent_runner_specs():
    """PartitionSpec pytree for RecurrentRunnerState (sharding layer)."""
    from jax.sharding import PartitionSpec as P

    from .parallel.mesh import ENV_AXIS
    from .types import EnvState

    env_spec = P(ENV_AXIS)
    rep = P()
    return RecurrentRunnerState(
        params=rep,
        opt_state=rep,
        env_state=EnvState(
            pos=env_spec, vel=env_spec, possession=env_spec,
            score=env_spec, t=env_spec, key=env_spec,
        ),
        obs=env_spec,
        # [2, B, lstm] carries; written without the trailing None, the
        # form shard_map returns, so iterations reuse one compile
        carry=(P(None, ENV_AXIS), P(None, ENV_AXIS)),
        key=rep,
    )


__all__ = [
    "A2CConfig",
    "RecurrentRunnerState",
    "RunnerState",
    "a2c_loss",
    "collect_recurrent_rollout",
    "init_recurrent_runner",
    "init_runner",
    "make_optimizer",
    "recurrent_a2c_loss",
    "recurrent_runner_specs",
    "train_iteration",
    "train_iteration_recurrent",
]
