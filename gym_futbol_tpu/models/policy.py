"""Actor-critic policy network for FutbolEnv.

The reference trains stable-baselines ``PPO2("MlpPolicy", env)`` (SURVEY.md
§3.5 [RECALL-M]) — a small MLP over the flat observation. Ours is the
same network in plain JAX: one shared torso, one categorical head per
(player, slot) pair (direction in 5, act in 5 — the ACTION SPEC in
:mod:`gym_futbol_tpu.game`), and a value head.

PARAMETERS. ``init`` returns the tree a ``flax.linen`` module of the same
shape would (``{"params": {"Dense_0": {"kernel", "bias"}, ...}}``), with
the same initialisers (lecun-normal kernels, zero biases) drawn from the
same per-parameter keys, so a seed gives the same weights and saved
weights load unchanged. ``apply(params, obs)`` is the forward.

LAYOUT. Logits stay FLAT: [B, G*5] with G = n_players*2 groups, and all
categorical math runs in ROW form — transpose once to [G*5, B] and
compute per distribution with dense [B] vectors, the same scalar-SSA
style as the physics engine — so no [B, n_players, 2, 5] intermediate
with tiny minor dims is ever materialised. Actions cross the PPO buffer
bit-packed (3 bits per value, one int32 word per slot) so the stacked
trajectory stays a clean 2-D [T, B] array.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ..types import EnvParams

N_CHOICES = 5  # both action slots are 5-way categoricals (ACTION SPEC)


def param_key(key: jax.Array, *path) -> jax.Array:
    """The init key of the parameter at ``path`` (module names, then the
    parameter's 1-based creation index in its module): SHA-1 of the path
    folded into ``key``, the derivation ``flax.linen`` uses."""
    h = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        else:
            h.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(h.digest()[:4], "big"))
    )


def dense_init(key: jax.Array, path: tuple, n_in: int, n_out: int,
               kernel_init=jax.nn.initializers.lecun_normal(),
               use_bias: bool = True) -> dict:
    """``{"kernel" [n_in, n_out], "bias" [n_out]}`` for the dense layer at
    ``path`` (kernel is its first parameter, bias its second)."""
    layer = {"kernel": kernel_init(param_key(key, *path, 1), (n_in, n_out),
                                   jnp.float32)}
    if use_bias:
        layer["bias"] = jnp.zeros((n_out,), jnp.float32)
    return layer


def dense(layer: dict, x: jax.Array, dtype) -> jax.Array:
    """``x @ kernel + bias`` over the last axis of ``x``."""
    y = jax.lax.dot_general(
        x, layer["kernel"].astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    return y + layer["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Shared-torso MLP actor-critic.

    Output logits shape [B, n_players*2*5], groups in (player-major,
    slot-minor) order: group ``2*p`` is player p's direction distribution,
    ``2*p + 1`` its act distribution.
    """

    n_players: int
    hidden: Sequence[int] = (256, 256)
    dtype: Any = jnp.float32

    def init(self, key: jax.Array, obs: jax.Array) -> dict:
        sizes = (obs.shape[-1], *self.hidden)
        n = len(self.hidden)
        params = {
            f"Dense_{i}": dense_init(key, (f"Dense_{i}",), a, b)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
        }
        params[f"Dense_{n}"] = dense_init(
            key, (f"Dense_{n}",), sizes[-1], self.n_players * 2 * N_CHOICES
        )
        params[f"Dense_{n + 1}"] = dense_init(
            key, (f"Dense_{n + 1}",), sizes[-1], 1
        )
        return {"params": params}

    def apply(self, variables: dict, obs: jax.Array
              ) -> tuple[jax.Array, jax.Array]:
        p = variables["params"]
        n = len(self.hidden)
        x = obs.astype(self.dtype)
        for i in range(n):
            x = jnp.tanh(dense(p[f"Dense_{i}"], x, self.dtype))
        logits = dense(p[f"Dense_{n}"], x, self.dtype)
        value = dense(p[f"Dense_{n + 1}"], x, self.dtype)
        return logits, value.squeeze(-1)


# ---------------------------------------------------------------------------
# Row-form categorical math (all intermediates are [B] vectors)
# ---------------------------------------------------------------------------


def _group_rows(logits: jax.Array) -> list[list[jax.Array]]:
    """[.., G*5] flat logits -> G groups of 5 rows, each row shaped [..]."""
    lt = jnp.moveaxis(logits, -1, 0)  # one efficient transpose
    g5 = logits.shape[-1]
    assert g5 % N_CHOICES == 0, f"logit dim {g5} not a multiple of 5"
    return [
        [lt[g * N_CHOICES + i] for i in range(N_CHOICES)]
        for g in range(g5 // N_CHOICES)
    ]


def _log_softmax_rows(rows: list[jax.Array]):
    """Returns (logp rows, exp rows, Z) for one 5-way distribution."""
    m = rows[0]
    for r in rows[1:]:
        m = jnp.maximum(m, r)
    exps = [jnp.exp(r - m) for r in rows]
    z = exps[0]
    for e in exps[1:]:
        z = z + e
    logz = jnp.log(z)
    return [r - m - logz for r in rows], exps, z


def sample_actions(
    key: jax.Array, logits: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Sample joint actions from flat [.., G*5] logits.

    Inverse-CDF sampling per group with one uniform draw each (same
    categorical distribution as gumbel-argmax, with [B]-vector shapes).
    Returns (actions int32 [.., n_players, 2], joint log-prob [..]).
    """
    groups = _group_rows(logits)
    n_groups = len(groups)
    batch_shape = logits.shape[:-1]
    u = jax.random.uniform(key, (n_groups,) + batch_shape, logits.dtype)

    idx_rows, logp_total = [], None
    for g, rows in enumerate(groups):
        logp, exps, z = _log_softmax_rows(rows)
        target = u[g] * z
        cum = exps[0]
        idx = (target > cum).astype(jnp.int32)
        for i in range(1, N_CHOICES - 1):
            cum = cum + exps[i]
            idx = idx + (target > cum).astype(jnp.int32)
        taken = logp[0]
        for i in range(1, N_CHOICES):
            taken = jnp.where(idx == i, logp[i], taken)
        idx_rows.append(idx)
        logp_total = taken if logp_total is None else logp_total + taken

    # [G, ..] -> [.., n_players, 2]
    actions = jnp.stack(idx_rows)  # [G, ..]
    actions = jnp.moveaxis(actions, 0, -1).reshape(
        batch_shape + (n_groups // 2, 2)
    )
    return actions, logp_total


def pack_actions(actions: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[.., n_players, 2] int32 -> (dirs_packed, acts_packed) [..] int32,
    3 bits per player. Keeps the PPO trajectory buffer 2-D (layout note in
    the module docstring). Supports n_players <= 10 (the reference's
    1v1..5v5 range)."""
    n_players = actions.shape[-2]
    assert n_players <= 10, "bit-packing supports at most 10 players"
    dirs = jnp.zeros(actions.shape[:-2], jnp.int32)
    acts = jnp.zeros(actions.shape[:-2], jnp.int32)
    for p in range(n_players):
        dirs = dirs | (actions[..., p, 0] << (3 * p))
        acts = acts | (actions[..., p, 1] << (3 * p))
    return dirs, acts


def action_log_prob_and_entropy_packed(
    logits: jax.Array, dirs_packed: jax.Array, acts_packed: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Joint log-prob of packed actions + total entropy, from flat logits.

    All math in row form — no [.., n_players, 2, 5] intermediates.
    """
    groups = _group_rows(logits)
    logp_total, ent_total = None, None
    for g, rows in enumerate(groups):
        p, slot = g // 2, g % 2
        packed = dirs_packed if slot == 0 else acts_packed
        a = (packed >> (3 * p)) & 7
        logp, exps, z = _log_softmax_rows(rows)
        taken = logp[0]
        ent = -exps[0] * logp[0]
        for i in range(1, N_CHOICES):
            taken = jnp.where(a == i, logp[i], taken)
            ent = ent - exps[i] * logp[i]
        ent = ent / z
        logp_total = taken if logp_total is None else logp_total + taken
        ent_total = ent if ent_total is None else ent_total + ent
    return logp_total, ent_total


def action_log_prob_and_entropy(
    logits: jax.Array, actions: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Joint log-prob of [.., n_players, 2] actions + total entropy
    (sum over the independent per-player, per-slot categoricals).
    Convenience wrapper over the packed row-form core."""
    dirs, acts = pack_actions(actions)
    return action_log_prob_and_entropy_packed(logits, dirs, acts)


def make_policy_fn(model: ActorCritic, params):
    """Adapter to the ``rollout(policy)`` signature in
    :mod:`gym_futbol_tpu.vector`."""

    def policy(key: jax.Array, obs: jax.Array) -> jax.Array:
        logits, _ = model.apply(params, obs)
        actions, _ = sample_actions(key, logits)
        return actions

    return policy


def make_normalized_policy_fn(model: ActorCritic, params, obs_norm):
    """Like :func:`make_policy_fn` for a policy trained through
    observation normalization (ppo.make_normalized_collect): applies the
    FROZEN ``obs_norm`` stats (wrappers.RunningNorm) to the raw env obs
    before the forward — VecNormalize eval semantics (stats are not
    updated at evaluation time)."""

    def policy(key: jax.Array, obs: jax.Array) -> jax.Array:
        logits, _ = model.apply(params, obs_norm.normalize(obs))
        actions, _ = sample_actions(key, logits)
        return actions

    return policy


def init_params(key: jax.Array, model: ActorCritic, env_params: EnvParams):
    from ..env import obs_size

    dummy = jnp.zeros((1, obs_size(env_params)), model.dtype)
    return model.init(key, dummy)
