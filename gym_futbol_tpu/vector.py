"""Vectorized FutbolEnv: thousands of envs in lockstep under jit+vmap.

This is the layer the reference lacks entirely — its only scale story is
stable-baselines' ``SubprocVecEnv`` Python processes (SURVEY.md §2.3).
Here the batch dimension is a ``vmap`` axis over the pure single-env
functions in :mod:`gym_futbol_tpu.env`, so single-env semantics stay
readable while XLA fuses the batched step into a few device kernels.

Auto-reset (BASELINE.json config 3) is built in: wherever ``done`` is hit,
the transition's outputs are returned as usual and the carried state is
replaced by a fresh episode (masked select — branch-free, SURVEY.md §7.4
item 7). ``rollout`` runs T steps entirely on-device with ``lax.scan``.

Layout note: the batched state is batch-LEADING ([B, ...] on every leaf);
a batch-minor ([..., B]) variant was measured and did not beat it — the
physics kernel already reads per-body *scalars* (see physics.py), which
under vmap are dense [B] vectors regardless of the state's stored layout,
and XLA lays out the small game-logic intermediates well either way.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from . import env as env_core
from .types import EnvParams, EnvState, StepOutput

# vmap in_axes/out_axes for a batched EnvState: batch-leading on every
# leaf, i.e. plain axis 0 (see module docstring).
STATE_AXES = 0


def reset_batch(
    key: jax.Array, params: EnvParams, n_envs: int, dtype=jnp.float32
) -> tuple[EnvState, jax.Array]:
    """Fresh batch of envs. Per-env independent RNG streams via key split
    (SURVEY.md §4.2 item 2: 'RNG stream independence across envs')."""
    keys = jax.random.split(key, n_envs)
    return jax.vmap(lambda k: env_core.reset(k, params, dtype))(keys)


@partial(jax.jit, static_argnames=("params",), donate_argnames=("state",))
def step_batch(
    state: EnvState, actions: jax.Array, params: EnvParams
) -> tuple[EnvState, StepOutput]:
    """Batched step WITH auto-reset-on-done.

    state: batched EnvState (leading env axis). actions: [B, n_players, 2].
    Returns (new_state, out): ``out.reward``/``done``/``info`` report the
    terminal transition, while ``new_state`` (and ``out.obs``, which
    follows it) has already been re-initialized where done — classic
    vec-env autoreset semantics; see :func:`gym_futbol_tpu.env.step`.

    Auto-reset happens *inside* ``env.step`` (static flag), reusing the
    step's own kickoff placement draw — zero extra RNG or reset work.
    """
    return jax.vmap(
        lambda s, a: env_core.step(s, a, params, auto_reset=True)
    )(state, actions)


def rollout(
    state: EnvState,
    policy: Callable[[jax.Array, jax.Array], jax.Array],
    key: jax.Array,
    params: EnvParams,
    n_steps: int,
) -> tuple[EnvState, StepOutput]:
    """Run ``n_steps`` batched steps fully on-device (lax.scan).

    ``policy(key, obs[B, obs_dim]) -> actions[B, n_players, 2]``.
    Returns final state + time-stacked StepOutput ([T, B, ...]).
    This is the hot loop the driver's configs 2-5 measure; contrast with
    the reference's Python-loop rollout (SURVEY.md §3.5).
    """
    obs0 = jax.vmap(
        lambda s: env_core.observe(s, params), in_axes=(STATE_AXES,)
    )(state)

    def body(carry, _):
        state, obs, key = carry
        key, k_act = jax.random.split(key)
        actions = policy(k_act, obs)
        state, out = step_batch(state, actions, params)
        return (state, out.obs, key), out

    (state, _, _), outs = jax.lax.scan(
        body, (state, obs0, key), None, length=n_steps
    )
    return state, outs


def random_policy(params: EnvParams) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Uniform-random joint action policy (driver configs 1-3)."""

    def policy(key: jax.Array, obs: jax.Array) -> jax.Array:
        b = obs.shape[0]
        return jax.random.randint(
            key, (b, params.n_players, 2), 0, 5, dtype=jnp.int32
        )

    return policy


class VectorFutbolEnv:
    """Stateful convenience wrapper over the batched pure core."""

    def __init__(
        self, n_envs: int, params: EnvParams | None = None, seed: int = 0,
        dtype=jnp.float32,
    ):
        self.params = params or EnvParams()
        self.n_envs = n_envs
        self.dtype = dtype
        self._key = jax.random.PRNGKey(seed)
        self._state: EnvState | None = None

    def reset(self) -> jax.Array:
        self._key, k = jax.random.split(self._key)
        self._state, obs = reset_batch(k, self.params, self.n_envs, self.dtype)
        return obs

    def step(self, actions: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, dict]:
        self._state, out = step_batch(self._state, actions, self.params)
        return out.obs, out.reward, out.done, out.info

    @property
    def state(self) -> EnvState:
        return self._state
