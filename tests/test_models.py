"""The plain-JAX ActorCritic and RecurrentActorCritic against the flax
modules they replaced: same parameter tree, same initial weights from a
seed, same outputs on identical parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_futbol_tpu.models.policy import N_CHOICES, ActorCritic
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic

nn = pytest.importorskip("flax.linen")


class FlaxActorCritic(nn.Module):
    n_players: int
    hidden: tuple = (256, 256)

    @nn.compact
    def __call__(self, obs):
        x = obs
        for w in self.hidden:
            x = nn.tanh(nn.Dense(w)(x))
        logits = nn.Dense(self.n_players * 2 * N_CHOICES)(x)
        return logits, nn.Dense(1)(x).squeeze(-1)


class FlaxRecurrentActorCritic(nn.Module):
    n_players: int
    hidden: tuple = (128,)
    lstm_size: int = 128

    @nn.compact
    def __call__(self, carry, obs):
        x = obs
        for w in self.hidden:
            x = nn.tanh(nn.Dense(w)(x))
        carry, x = nn.OptimizedLSTMCell(self.lstm_size)(carry, x)
        logits = nn.Dense(self.n_players * 2 * N_CHOICES)(x)
        return carry, (logits, nn.Dense(1)(x).squeeze(-1))


def _same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype


@pytest.mark.parametrize("n_players,hidden", [(2, (256, 256)), (5, (32,))])
def test_actor_critic_matches_flax(n_players, hidden):
    key = jax.random.PRNGKey(3)
    obs = jax.random.normal(jax.random.PRNGKey(4), (16, 4 * (2 * n_players + 1) + 2))
    ours = ActorCritic(n_players=n_players, hidden=hidden)
    ref = FlaxActorCritic(n_players=n_players, hidden=hidden)
    p_ours, p_ref = ours.init(key, obs[:1]), ref.init(key, obs[:1])
    _same_tree(p_ours, p_ref)
    for x, y in zip(jax.tree.leaves(p_ours), jax.tree.leaves(p_ref)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for a, b in zip(ours.apply(p_ref, obs), ref.apply(p_ref, obs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_recurrent_matches_flax():
    key = jax.random.PRNGKey(5)
    obs = jax.random.normal(jax.random.PRNGKey(6), (8, 22))
    ours = RecurrentActorCritic(n_players=2, hidden=(16,), lstm_size=12)
    ref = FlaxRecurrentActorCritic(n_players=2, hidden=(16,), lstm_size=12)
    carry = ours.initial_carry(8)
    p_ours, p_ref = ours.init(key, carry, obs), ref.init(key, carry, obs)
    _same_tree(p_ours, p_ref)
    assert set(p_ours["params"]["OptimizedLSTMCell_0"]) == {
        "ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    for x, y in zip(jax.tree.leaves(p_ours), jax.tree.leaves(p_ref)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # two steps, so the carry path is exercised with nonzero state
    c_a, c_b = carry, carry
    for _ in range(2):
        c_a, (la, va) = ours.apply(p_ref, c_a, obs)
        c_b, (lb, vb) = ref.apply(p_ref, c_b, obs)
    for a, b in zip((*c_a, la, va), (*c_b, lb, vb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_recurrent_kernels_orthogonal():
    m = RecurrentActorCritic(n_players=1, hidden=(8,), lstm_size=8)
    p = m.init(jax.random.PRNGKey(0), m.initial_carry(1), jnp.zeros((1, 14)))
    w = np.asarray(p["params"]["OptimizedLSTMCell_0"]["hf"]["kernel"])
    np.testing.assert_allclose(w.T @ w, np.eye(8), atol=1e-5)
    assert not np.asarray(p["params"]["OptimizedLSTMCell_0"]["hf"]["bias"]).any()


def test_saved_demo_weights_still_load():
    """The committed recurrent demo weights (written by the flax module)
    restore into the new model's tree."""
    import os

    serialization = pytest.importorskip("flax.serialization")
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "parity",
                        "artifacts", "demo_recurrent_weights.msgpack")
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    params = raw["params"] if "params" in raw else raw
    lstm = params["params"]["OptimizedLSTMCell_0"]
    size = lstm["hi"]["kernel"].shape[0]
    hidden = tuple(params["params"][f"Dense_{i}"]["kernel"].shape[1]
                   for i in range(len(params["params"]) - 3))
    n_in = params["params"]["Dense_0"]["kernel"].shape[0]
    n_players = params["params"][f"Dense_{len(hidden)}"]["kernel"].shape[1] // 10
    m = RecurrentActorCritic(n_players=n_players, hidden=hidden, lstm_size=size)
    template = m.init(jax.random.PRNGKey(0), m.initial_carry(1),
                      jnp.zeros((1, n_in)))
    _same_tree(template, jax.tree.map(jnp.asarray, params))
    _, (logits, value) = m.apply(params, m.initial_carry(4),
                                 jnp.zeros((4, n_in)))
    assert np.isfinite(np.asarray(logits)).all()
