"""gym_futbol_tpu — a vectorized soccer environment engine in JAX.

Brand-new framework with the capabilities of the reference
``yc2454/gym-futbol`` ``FutbolEnv`` (see SURVEY.md), re-designed for
accelerators: pure-functional JAX state transitions under jit/vmap, env
batches sharded over device meshes with shard_map, a fused Pallas rollout
kernel for the GPU, and a sharded PPO learner.

Quick start::

    import jax
    from gym_futbol_tpu import EnvParams, reset, step

    params = EnvParams(players_per_team=2)
    state, obs = reset(jax.random.PRNGKey(0), params)
    actions = jax.numpy.zeros((params.n_players, 2), jax.numpy.int32)
    state, out = step(state, actions, params)
"""

from .entities import Ball, Player, Team
from .env import FutbolEnv, observe, obs_size, reset, step
from .registry import make, make_params, register, registered_ids
from .spaces import Box, Discrete, MultiDiscrete
from .types import EnvParams, EnvState, RewardConfig, StepOutput

__version__ = "0.1.0"

__all__ = [
    "EnvParams",
    "EnvState",
    "RewardConfig",
    "StepOutput",
    "FutbolEnv",
    "reset",
    "step",
    "observe",
    "obs_size",
    "make",
    "make_params",
    "register",
    "registered_ids",
    "Ball",
    "Player",
    "Team",
    "Box",
    "Discrete",
    "MultiDiscrete",
    "__version__",
]
