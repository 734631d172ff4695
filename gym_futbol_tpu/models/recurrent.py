"""Recurrent (LSTM) actor-critic for FutbolEnv.

The stable-baselines policy family the reference trains with includes
``MlpLstmPolicy`` alongside ``MlpPolicy`` (SURVEY.md §3.5). This is its
analog in plain JAX: an MLP torso, an LSTM cell carried across env steps
(reset where ``done``), and the same flat-logits categorical heads as
:mod:`gym_futbol_tpu.models.policy` (layout notes there apply — all
categorical math stays in row form).

The parameter tree, initialisers and per-parameter init keys are those of
the equivalent ``flax.linen`` module (Dense torso, ``OptimizedLSTMCell``
with gate kernels ``i{i,f,g,o}`` / ``h{i,f,g,o}``, orthogonal recurrent
kernels), so saved weights load unchanged.

The hidden state is part of the rollout carry, so recurrent rollouts are
still a single ``lax.scan`` on device; a whole A2C-style iteration stays
one jittable function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ..types import EnvParams
from .policy import N_CHOICES, dense, dense_init

_GATES = ("i", "f", "g", "o")
_CELL = "OptimizedLSTMCell_0"


def _lstm_init(key: jax.Array, n_in: int, size: int) -> dict:
    cell = {}
    for g in _GATES:
        cell[f"i{g}"] = dense_init(key, (_CELL, f"i{g}"), n_in, size,
                                   use_bias=False)
        cell[f"h{g}"] = dense_init(key, (_CELL, f"h{g}"), size, size,
                                   jax.nn.initializers.orthogonal())
    return cell


def _lstm_cell(cell: dict, carry, x: jax.Array, dtype):
    """One LSTM step: i, f, o sigmoid gates, g tanh; c' = f*c + i*g,
    h' = o*tanh(c'). Gate kernels are concatenated into one product per
    input, as ``flax.linen.OptimizedLSTMCell`` computes it."""
    c, h = carry
    w_h = jnp.concatenate([cell[f"h{g}"]["kernel"] for g in _GATES], -1)
    b_h = jnp.concatenate([cell[f"h{g}"]["bias"] for g in _GATES], -1)
    w_i = jnp.concatenate([cell[f"i{g}"]["kernel"] for g in _GATES], -1)
    y = (jnp.dot(h.astype(dtype), w_h.astype(dtype)) + b_h.astype(dtype)
         + jnp.dot(x.astype(dtype), w_i.astype(dtype)))
    i, f, g, o = jnp.split(y, 4, axis=-1)
    new_c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    new_h = jax.nn.sigmoid(o) * jnp.tanh(new_c)
    return (new_c, new_h), new_h


@dataclasses.dataclass(frozen=True)
class RecurrentActorCritic:
    """MLP torso -> LSTM cell -> flat categorical heads + value head.

    ``apply(params, carry, obs) -> (new_carry, (logits [B,
    n_players*2*5], value [B]))``. Use :meth:`initial_carry` for the zero
    state.
    """

    n_players: int
    hidden: Sequence[int] = (128,)
    lstm_size: int = 128
    dtype: Any = jnp.float32

    def init(self, key: jax.Array, carry, obs: jax.Array) -> dict:
        del carry  # shapes follow from obs and lstm_size
        sizes = (obs.shape[-1], *self.hidden)
        n = len(self.hidden)
        params = {
            f"Dense_{i}": dense_init(key, (f"Dense_{i}",), a, b)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
        }
        params[_CELL] = _lstm_init(key, sizes[-1], self.lstm_size)
        params[f"Dense_{n}"] = dense_init(
            key, (f"Dense_{n}",), self.lstm_size,
            self.n_players * 2 * N_CHOICES,
        )
        params[f"Dense_{n + 1}"] = dense_init(
            key, (f"Dense_{n + 1}",), self.lstm_size, 1
        )
        return {"params": params}

    def apply(self, variables: dict, carry, obs: jax.Array):
        p = variables["params"]
        n = len(self.hidden)
        x = obs.astype(self.dtype)
        for i in range(n):
            x = jnp.tanh(dense(p[f"Dense_{i}"], x, self.dtype))
        carry, x = _lstm_cell(p[_CELL], carry, x, self.dtype)
        logits = dense(p[f"Dense_{n}"], x, self.dtype)
        value = dense(p[f"Dense_{n + 1}"], x, self.dtype)
        return carry, (logits, value.squeeze(-1))

    def initial_carry(self, batch_size: int):
        z = jnp.zeros((batch_size, self.lstm_size), self.dtype)
        return (z, z)


def reset_carry_where_done(carry, done: jax.Array):
    """Zero the LSTM state of finished episodes (done: [B] bool)."""
    mask = 1.0 - done.astype(carry[0].dtype)[:, None]
    return tuple(c * mask for c in carry)


def init_recurrent_params(
    key: jax.Array, model: RecurrentActorCritic, env_params: EnvParams,
    batch_size: int = 1,
):
    from ..env import obs_size

    dummy = jnp.zeros((batch_size, obs_size(env_params)), model.dtype)
    return model.init(key, model.initial_carry(batch_size), dummy)


def recurrent_rollout(
    params, model: RecurrentActorCritic, env_state, obs, carry,
    key: jax.Array, env_params: EnvParams, n_steps: int,
):
    """T recurrent steps fully on-device. Returns (env_state, obs, carry,
    (logits, value, actions, logp, reward, done) stacked [T, ...])."""
    from ..vector import step_batch
    from .policy import sample_actions

    def body(c, _):
        env_state, obs, carry, key = c
        key, k_act = jax.random.split(key)
        carry, (logits, value) = model.apply(params, carry, obs)
        actions, logp = sample_actions(k_act, logits)
        env_state, out = step_batch(env_state, actions, env_params)
        carry = reset_carry_where_done(carry, out.done)
        ys = (value, logp, out.reward, out.done)
        return (env_state, out.obs, carry, key), ys

    (env_state, obs, carry, _), ys = jax.lax.scan(
        body, (env_state, obs, carry, key), None, length=n_steps
    )
    return env_state, obs, carry, ys
