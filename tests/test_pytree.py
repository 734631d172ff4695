"""gym_futbol_tpu.pytree: frozen dataclasses registered as pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_futbol_tpu import pytree
from gym_futbol_tpu.types import EnvState


@pytree.dataclass
class Box:
    a: jax.Array
    b: jax.Array = None
    name: str = pytree.field(pytree_node=False, default="box")


def test_flatten_unflatten_roundtrip():
    x = Box(a=jnp.arange(3.0), b=jnp.ones((2, 2)), name="x")
    leaves, treedef = jax.tree.flatten(x)
    assert len(leaves) == 2               # name is static metadata
    y = jax.tree.unflatten(treedef, [2 * l for l in leaves])
    assert isinstance(y, Box) and y.name == "x"
    np.testing.assert_array_equal(np.asarray(y.a), 2 * np.arange(3.0))
    z = jax.jit(lambda t: jax.tree.map(lambda v: v + 1, t))(x)
    assert z.name == "x" and float(z.b[0, 0]) == 2.0


def test_replace_and_frozen():
    x = Box(a=jnp.zeros(2))
    y = x.replace(a=jnp.ones(2), name="y")
    assert x.name == "box" and y.name == "y"
    assert float(x.a[0]) == 0.0 and float(y.a[0]) == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        x.a = jnp.ones(2)


def test_none_field_is_empty_subtree():
    assert len(jax.tree.leaves(Box(a=jnp.zeros(1)))) == 1


def test_metadata_is_part_of_structure():
    s1 = jax.tree.structure(Box(a=jnp.zeros(1), name="p"))
    s2 = jax.tree.structure(Box(a=jnp.zeros(1), name="q"))
    assert s1 != s2


def test_env_state_vmaps():
    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.vector import reset_batch

    state, _ = reset_batch(jax.random.PRNGKey(0), EnvParams(), 4)
    assert isinstance(state, EnvState) and state.pos.shape == (4, 5, 2)
    one = jax.tree.map(lambda v: v[1], state)
    assert one.pos.shape == (5, 2)
