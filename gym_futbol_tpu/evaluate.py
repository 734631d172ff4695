"""Policy evaluation: head-to-head matches fully on-device.

The env is symmetric multi-agent (joint actions for both teams), so
evaluation composes per-team policies into a joint policy and scans
full episodes. Supports policy-vs-random, policy-vs-policy (self-play
leagues), and random-vs-random baselines.

Usage:
    from gym_futbol_tpu.evaluate import evaluate
    result = evaluate(params, policy_a=my_policy, n_envs=256, n_steps=300)
    # result["goals"] [2], result["win_rate"], ...
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from .env import mirror_actions, mirror_obs  # canonical defs live in env
from .types import EnvParams
from .vector import reset_batch, rollout

# A team policy maps (key, obs[B, obs_dim]) -> actions [B, ppt, 2]
TeamPolicy = Callable[[jax.Array, jax.Array], jax.Array]


def random_team_policy(params: EnvParams) -> TeamPolicy:
    def policy(key: jax.Array, obs: jax.Array) -> jax.Array:
        b = obs.shape[0]
        return jax.random.randint(
            key, (b, params.players_per_team, 2), 0, 5, dtype=jnp.int32
        )

    return policy


def joint_policy(
    params: EnvParams, policy_a: TeamPolicy, policy_b: TeamPolicy,
) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Compose two team policies into the env's joint-action policy.
    policy_b sees the mirrored observation (plays 'as team 0')."""

    def policy(key: jax.Array, obs: jax.Array) -> jax.Array:
        ka, kb = jax.random.split(key)
        act_a = policy_a(ka, obs)
        act_b = policy_b(kb, mirror_obs(obs, params))
        # map team 1's choices back to the world frame (swap left/right)
        act_b = mirror_actions(act_b)
        return jnp.concatenate([act_a, act_b], axis=-2)

    return policy


@partial(jax.jit, static_argnames=("params", "n_envs", "n_steps", "policy"))
def _run_matches(key, params: EnvParams, n_envs: int, n_steps: int, policy):
    k_reset, k_roll = jax.random.split(key)
    state, _ = reset_batch(k_reset, params, n_envs)
    state, outs = rollout(state, policy, k_roll, params, n_steps)
    goals = outs.info["goal"]                 # [T, B, 2] bool
    total_goals = goals.sum(axis=(0, 1))      # [2]
    per_env = goals.sum(axis=0)               # [B, 2]
    wins_a = (per_env[:, 0] > per_env[:, 1]).mean()
    wins_b = (per_env[:, 1] > per_env[:, 0]).mean()
    draws = (per_env[:, 0] == per_env[:, 1]).mean()
    return {
        "goals": total_goals,
        "goals_per_episode": total_goals / n_envs,
        "win_rate_a": wins_a,
        "win_rate_b": wins_b,
        "draw_rate": draws,
        "mean_team0_reward": outs.team_reward[..., 0].mean(),
    }


def evaluate(
    params: EnvParams,
    policy_a: TeamPolicy | None = None,
    policy_b: TeamPolicy | None = None,
    n_envs: int = 256,
    n_steps: int = 300,
    seed: int = 0,
) -> dict:
    """Run n_envs parallel matches of n_steps; returns host-side metrics.
    Defaults to random policies for any side not given."""
    policy_a = policy_a or random_team_policy(params)
    policy_b = policy_b or random_team_policy(params)
    policy = joint_policy(params, policy_a, policy_b)
    out = _run_matches(jax.random.PRNGKey(seed), params, n_envs, n_steps, policy)
    return {k: jax.device_get(v) for k, v in out.items()}


def evaluate_recurrent(
    params: EnvParams,
    model,
    variables,
    policy_b: TeamPolicy | None = None,
    variables_b=None,
    n_envs: int = 1024,
    n_steps: int = 300,
    seed: int = 0,
) -> dict:
    """Head-to-head evaluation with a RECURRENT team-0 policy
    (models.recurrent.RecurrentActorCritic): the LSTM carry is threaded
    through the episode scan and zeroed where an episode ends — the eval
    story for the MlpLstmPolicy analog (SURVEY.md §3.5). Team 1 runs
    either ``variables_b`` — a second parameter set for the SAME
    recurrent model, with its own carry on the mirrored view (recurrent
    leagues / monotonicity checks) — or the stateless ``policy_b``
    (default: uniform random). Same metric semantics as
    :func:`evaluate`."""
    from .models.policy import sample_actions
    from .models.recurrent import reset_carry_where_done
    from .vector import step_batch

    policy_b = policy_b or random_team_policy(params)
    recurrent_b = variables_b is not None

    @partial(jax.jit, static_argnames=())
    def run(key):
        k_reset, k_roll = jax.random.split(key)
        state, obs = reset_batch(k_reset, params, n_envs)
        carry = model.initial_carry(n_envs)
        carry_b = model.initial_carry(n_envs)

        def body(c, k):
            state, obs, carry, carry_b = c
            ka, kb = jax.random.split(k)
            carry, (logits, _) = model.apply(variables, carry, obs)
            act_a, _ = sample_actions(ka, logits)
            if recurrent_b:
                carry_b, (logits_b, _) = model.apply(
                    variables_b, carry_b, mirror_obs(obs, params)
                )
                raw_b, _ = sample_actions(kb, logits_b)
                act_b = mirror_actions(raw_b)
            else:
                act_b = mirror_actions(policy_b(kb, mirror_obs(obs, params)))
            joint = jnp.concatenate([act_a, act_b], axis=-2)
            state, out = step_batch(state, joint, params)
            carry = reset_carry_where_done(carry, out.done)
            carry_b = reset_carry_where_done(carry_b, out.done)
            return (state, out.obs, carry, carry_b), (out.info["goal"],
                                                      out.team_reward[:, 0])

        keys = jax.random.split(k_roll, n_steps)
        _, (goals, rew0) = jax.lax.scan(
            body, (state, obs, carry, carry_b), keys
        )
        total_goals = goals.sum(axis=(0, 1))
        per_env = goals.sum(axis=0)
        return {
            "goals": total_goals,
            "goals_per_episode": total_goals / n_envs,
            "win_rate_a": (per_env[:, 0] > per_env[:, 1]).mean(),
            "win_rate_b": (per_env[:, 1] > per_env[:, 0]).mean(),
            "draw_rate": (per_env[:, 0] == per_env[:, 1]).mean(),
            "mean_team0_reward": rew0.mean(),
        }

    out = run(jax.random.PRNGKey(seed))
    return {k: jax.device_get(v) for k, v in out.items()}
