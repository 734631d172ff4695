"""Recurrent (LSTM) PPO — the stable-baselines ``MlpLstmPolicy`` + PPO2
analog (SURVEY.md §3.5; VERDICT r4 item 1a).

The reference family trains its LSTM policy with PPO2 at least as often
as with A2C; :mod:`gym_futbol_tpu.a2c` covers the recurrent A2C side
(full-batch BPTT), and this module is the clipped-surrogate companion:

- collect: the EXISTING recurrent self-play rollout
  (:func:`a2c.collect_recurrent_rollout`) — obs [T, 2B, F] with the
  per-perspective carry zeroed at episode bounds;
- update: ``cfg.epochs`` x ``cfg.minibatches`` clipped-ratio SGD steps
  where minibatches partition the SEQUENCE axis (the 2B self-play
  perspectives), never the time axis — each minibatch re-runs the LSTM
  over the whole [T] window from the rollout's initial carry for its
  sequences, so gradients flow through time exactly as in the full-batch
  A2C loss while the data still gets the PPO epoch/minibatch treatment
  (stable-baselines PPO2 slices ``nminibatches`` along the env axis for
  recurrent policies for the same reason).

Layout notes: the per-epoch shuffle permutes CONTIGUOUS BLOCKS of
sequences (``cfg.shuffle_block``, degrading to the largest divisor —
same rationale as ppo.PPOConfig.shuffle_block: whole chunks instead of
row-level gathers over a [T, 2B, F] buffer), and the BPTT scan applies
``jax.checkpoint`` around the per-step cell when ``cfg.remat`` so the
backward pass recomputes [S, hidden] activations instead of streaming
T of them through device memory.

The whole iteration is one pure jittable function, signature-compatible
with the sharding layer (``a2c.recurrent_runner_specs()``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import optax

from .a2c import (
    RecurrentRunnerState,
    _flat_carry,
    collect_recurrent_rollout,
)
from .models.policy import action_log_prob_and_entropy_packed
from .models.recurrent import reset_carry_where_done
from .ppo import PPOConfig, Transition, _shuffle_block_for, compute_gae
from .types import EnvParams

__all__ = [
    "RecurrentPPOConfig",
    "init_recurrent_ppo_runner",
    "make_optimizer",
    "recurrent_ppo_loss",
    "train_iteration_recurrent_ppo",
    "update_epochs_recurrent",
]


@dataclasses.dataclass(frozen=True)
class RecurrentPPOConfig(PPOConfig):
    """PPOConfig with recurrent-friendly defaults: short windows (the
    LSTM carries context across iterations, and GAE over T=16 keeps the
    advantage bias small at gamma=0.99) and sequence-axis minibatching
    (``shuffle_block`` counts SEQUENCES here, not flat samples)."""

    rollout_steps: int = 16
    shuffle_block: int = 512


def make_optimizer(cfg: PPOConfig, total_iters: int | None = None):
    """Same Adam + clip + linear-anneal-to-floor as :func:`ppo.make_optimizer`."""
    from .ppo import make_optimizer as _mk

    return _mk(cfg, total_iters=total_iters)


def init_recurrent_ppo_runner(
    key: jax.Array, model, env_params: EnvParams, cfg: PPOConfig,
    n_envs: int, tx,
) -> RecurrentRunnerState:
    """Same runner pytree as recurrent A2C (a2c.init_recurrent_runner) —
    the algorithms share collect, state layout and sharding specs."""
    from .a2c import init_recurrent_runner

    return init_recurrent_runner(key, model, env_params, cfg, n_envs, tx)


def recurrent_ppo_loss(
    params, model, traj: Transition, init_carry, adv: jax.Array,
    returns: jax.Array, cfg: PPOConfig,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Clipped-surrogate PPO loss over a [T, S] window of S sequences.

    The forward pass is a BPTT scan from ``init_carry`` (the carry the
    behavior policy started this window with, for these sequences),
    resetting at episode bounds exactly as the collect did — so at the
    first epoch the recomputed log-probs equal ``traj.logp`` bitwise on
    the jnp path and the ratio starts at 1. Advantages are normalized
    over the whole minibatch (all T*S elements), matching
    :func:`ppo.ppo_loss`.
    """

    def apply_step(p, c, o):
        return model.apply(p, c, o)

    if cfg.remat:
        apply_step = jax.checkpoint(apply_step)

    def body(c, tr):
        c2, (logits, value) = apply_step(params, c, tr.obs)
        logp, ent = action_log_prob_and_entropy_packed(
            logits, tr.dirs, tr.acts
        )
        c2 = reset_carry_where_done(c2, tr.done)
        return c2, (logp, ent, value)

    _, (logp, entropy, value) = jax.lax.scan(body, init_carry, traj)

    ratio = jnp.exp(logp - traj.logp)
    norm_adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * norm_adv
    pg2 = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * norm_adv
    pg_loss = -jnp.minimum(pg1, pg2).mean()

    v_clipped = traj.value + jnp.clip(
        value - traj.value, -cfg.clip_eps, cfg.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - returns) ** 2, (v_clipped - returns) ** 2
    ).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "approx_kl": ((ratio - 1) - jnp.log(ratio)).mean(),
    }


def update_epochs_recurrent(
    params, opt_state, traj: Transition, init_carry, adv, returns,
    key: jax.Array, model, tx, cfg: PPOConfig,
    axis_name: str | None = None,
):
    """cfg.epochs x cfg.minibatches clipped-surrogate steps, minibatched
    over the SEQUENCE axis. ``traj`` fields are [T, S(, F)] with S = 2B
    self-play perspectives; ``init_carry`` leaves are [S, H]. Sequences
    are gathered in contiguous blocks (cfg.shuffle_block sequences per
    block, degrading via ppo._shuffle_block_for) so the per-epoch
    permutation moves whole [T, block(, F)] slabs.
    """
    t, s = traj.reward.shape
    block = _shuffle_block_for(s, cfg)
    n_blocks = s // block
    mb_blocks = n_blocks // cfg.minibatches

    # [T, S, ...] -> [T, n_blocks, block, ...]; carries [S, H] ->
    # [n_blocks, block, H]. Gathers then index the block axis only.
    seq_blk = jax.tree.map(
        lambda x: x.reshape((t, n_blocks, block) + x.shape[2:]), traj
    )
    adv_blk = adv.reshape(t, n_blocks, block)
    ret_blk = returns.reshape(t, n_blocks, block)
    carry_blk = jax.tree.map(
        lambda c: c.reshape((n_blocks, block) + c.shape[1:]), init_carry
    )

    def epoch(carry, k):
        params, opt_state = carry
        perm = jax.random.permutation(k, n_blocks)

        def minibatch(carry, idx):
            params, opt_state = carry
            take_t = lambda x: jnp.take(x, idx, axis=1).reshape(
                (t, mb_blocks * block) + x.shape[3:]
            )
            mb_traj = jax.tree.map(take_t, seq_blk)
            mb_carry = jax.tree.map(
                lambda c: jnp.take(c, idx, axis=0).reshape(
                    (mb_blocks * block,) + c.shape[2:]
                ),
                carry_blk,
            )
            grads, metrics = jax.grad(recurrent_ppo_loss, has_aux=True)(
                params, model, mb_traj, mb_carry, take_t(adv_blk),
                take_t(ret_blk), cfg,
            )
            if axis_name is not None:
                grads = jax.lax.pmean(grads, axis_name)
                metrics = jax.lax.pmean(metrics, axis_name)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), metrics

        idxs = perm[: cfg.minibatches * mb_blocks].reshape(
            cfg.minibatches, mb_blocks
        )
        (params, opt_state), metrics = jax.lax.scan(
            minibatch, (params, opt_state), idxs
        )
        return (params, opt_state), metrics

    keys = jax.random.split(key, cfg.epochs)
    (params, opt_state), metrics = jax.lax.scan(
        epoch, (params, opt_state), keys
    )
    return params, opt_state, jax.tree.map(lambda m: m.mean(), metrics)


def train_iteration_recurrent_ppo(
    runner: RecurrentRunnerState, model, env_params: EnvParams,
    cfg: PPOConfig, tx, axis_name: str | None = None,
) -> tuple[RecurrentRunnerState, dict[str, jax.Array]]:
    """One recurrent PPO iteration: recurrent self-play rollout -> GAE ->
    sequence-minibatched clipped-surrogate epochs. Pure and jittable;
    signature-compatible with the sharding layer (pass
    ``runner_specs=a2c.recurrent_runner_specs()``)."""
    b = runner.obs.shape[0]
    init_carry = _flat_carry(runner.carry, b)
    runner, traj, last_value = collect_recurrent_rollout(
        runner, model, env_params, cfg
    )
    adv, returns = compute_gae(traj, last_value, cfg)
    key, k_update = jax.random.split(runner.key)
    params, opt_state, metrics = update_epochs_recurrent(
        runner.params, runner.opt_state, traj, init_carry, adv, returns,
        k_update, model, tx, cfg, axis_name,
    )
    metrics["mean_reward"] = traj.reward[
        :, : traj.reward.shape[1] // 2
    ].mean()
    if axis_name is not None:
        metrics["mean_reward"] = jax.lax.pmean(
            metrics["mean_reward"], axis_name
        )
    return runner.replace(params=params, opt_state=opt_state, key=key), metrics
