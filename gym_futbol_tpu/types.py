"""Core types for the FutbolEnv engine.

Design per SURVEY.md §7.2 step 1. The reference (`yc2454/gym-futbol`,
mount empty at survey + build time — SURVEY.md §0) holds its configuration
as hard-coded constants plus ``FutbolEnv.__init__`` kwargs (width, height,
players-per-team, time limit, body masses/radii, force/impulse magnitudes,
goal size, dt) and its mutable world state inside a ``pymunk.Space``.

Here the split is JAX-idiomatic instead:

- :class:`EnvParams` — a *frozen, hashable* Python dataclass. Passed to
  every pure function as a **static** argument so XLA constant-folds all
  physics/game constants into the compiled step. One compiled executable
  per distinct param set (the normal case: one per experiment).
- :class:`EnvState` — a pytree (:func:`gym_futbol_tpu.pytree.dataclass`) of arrays: the
  full world state of ONE environment. Batching is purely external via
  ``jax.vmap`` (SURVEY.md §7.2: "single-env semantics stay readable").

Body layout convention (everywhere in this package):
    index 0                      -> ball
    indices 1 .. ppt             -> team 0 ("home", defends left goal,
                                    attacks the right goal at x = width)
    indices ppt+1 .. 2*ppt       -> team 1 ("away", attacks left goal)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from . import pytree

# ---------------------------------------------------------------------------
# Static configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Shaped-reward coefficients.

    The reference applies a large terminal goal reward plus dense shaping
    (SURVEY.md §2.1 #8; exact constants are [RECALL-L] and unverifiable
    while the mount is empty — these defaults are chosen to be sane for
    PPO and are fully configurable).
    All rewards are expressed from the perspective of a team; team 1's
    reward is computed by mirroring.
    """

    goal: float = 10.0                 # scoring team, per goal
    concede: float = -10.0             # conceding team, per goal
    ball_to_goal_delta: float = 0.1    # * (decrease in ball->opp-goal dist)
    player_to_ball_delta: float = 0.01 # * (decrease in nearest-player->ball dist)
    possession_bonus: float = 0.001    # per step while a team member owns ball
    oob_penalty: float = -0.1          # ball forced back in bounds (non-goal)
    time_penalty: float = 0.0          # per step


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """All static environment configuration.

    Frozen + hashable => usable as a jit static argument; every float here
    becomes an XLA constant in the compiled step. Geometry follows the
    reference's pixel-style units (field 600x400, SURVEY.md §2.1 #3 tags
    these [RECALL-M]; re-cite when the mount populates).
    """

    # --- team structure ---
    players_per_team: int = 2

    # --- geometry ---
    width: float = 600.0
    height: float = 400.0
    goal_size: float = 100.0           # opening in each side wall, centered
    player_radius: float = 15.0
    ball_radius: float = 10.0

    # --- masses / material ---
    player_mass: float = 20.0
    ball_mass: float = 1.0
    player_elasticity: float = 0.2     # circle-circle restitution (product rule)
    ball_elasticity: float = 0.6
    wall_elasticity: float = 0.8
    friction: float = 0.4              # tangential (Coulomb) coefficient

    # --- integration (pymunk/Chipmunk semantics, SURVEY.md §3.3/§7.4) ---
    dt: float = 0.1                    # one env.step advances this much sim time
    substeps: int = 5                  # physics sub-steps per env.step
    damping: float = 0.95              # velocity kept per second (pymunk space.damping)
    solver_iterations: int = 10        # Chipmunk default space.iterations
    collision_slop: float = 0.1        # allowed penetration (Chipmunk default)
    baumgarte: float = 0.2             # positional-bias fraction per substep
    max_speed: float = 500.0           # hard speed clamp (stability)

    # --- action semantics (SURVEY.md §2.1 #4, [RECALL-L] constants) ---
    move_force: float = 2000.0         # continuous force while arrow held
    dash_multiplier: float = 2.5       # dash: move_force * this
    possession_radius: float = 40.0    # press/grab reach (center-to-center)
    dribble_offset: float = 2.0        # ball sits this far beyond player radius
    pass_power: float = 300.0          # impulse magnitude on pass
    shoot_power: float = 600.0         # impulse magnitude on shoot
    kick_noise: float = 0.05           # stddev (radians) of kick direction noise

    # --- placement ---
    placement_noise: float = 0.02      # kickoff jitter, fraction of height

    # --- episode ---
    max_steps: int = 300               # done when t >= max_steps

    # --- rewards ---
    rewards: RewardConfig = dataclasses.field(default_factory=RewardConfig)

    # ------------------------------------------------------------------
    # Derived (properties keep the dataclass hashable & simple)
    # ------------------------------------------------------------------
    @property
    def n_players(self) -> int:
        return 2 * self.players_per_team

    @property
    def n_bodies(self) -> int:
        """Ball + all players."""
        return 1 + 2 * self.players_per_team

    @property
    def goal_y_lo(self) -> float:
        return (self.height - self.goal_size) / 2.0

    @property
    def goal_y_hi(self) -> float:
        return (self.height + self.goal_size) / 2.0

    def replace(self, **kw: Any) -> "EnvParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Dynamic state
# ---------------------------------------------------------------------------


@pytree.dataclass
class EnvState:
    """World state of a single environment (pytree).

    Batched only externally via ``vmap``; every field's leading dims are
    exactly as documented. ``possession`` uses *body* index (1..2*ppt) or
    -1 for a free ball — the ball (body 0) can never possess itself.
    """

    pos: jax.Array          # [n_bodies, 2] float
    vel: jax.Array          # [n_bodies, 2] float
    possession: jax.Array   # [] int32, body index of owner or -1
    score: jax.Array        # [2] int32, goals by team 0 / team 1
    t: jax.Array            # [] int32, env steps elapsed this episode
    key: jax.Array          # PRNG key threaded through steps

    @property
    def ball_pos(self) -> jax.Array:
        return self.pos[0]

    @property
    def ball_vel(self) -> jax.Array:
        return self.vel[0]


@pytree.dataclass
class StepOutput:
    """Everything ``step`` returns besides the new state."""

    obs: jax.Array          # [obs_dim]
    reward: jax.Array       # [] float, team-0 perspective (gym-compatible)
    team_reward: jax.Array  # [2] float, per-team shaped reward
    done: jax.Array         # [] bool
    info: dict[str, jax.Array]


def body_masses(params: EnvParams, dtype=jnp.float32) -> jax.Array:
    """[n_bodies] masses: ball first, then players."""
    return jnp.concatenate([
        jnp.array([params.ball_mass], dtype=dtype),
        jnp.full((params.n_players,), params.player_mass, dtype=dtype),
    ])


def body_radii(params: EnvParams, dtype=jnp.float32) -> jax.Array:
    """[n_bodies] radii: ball first, then players."""
    return jnp.concatenate([
        jnp.array([params.ball_radius], dtype=dtype),
        jnp.full((params.n_players,), params.player_radius, dtype=dtype),
    ])


def body_elasticities(params: EnvParams, dtype=jnp.float32) -> jax.Array:
    """[n_bodies] per-shape elasticity (pairwise combined multiplicatively,
    the Chipmunk rule)."""
    return jnp.concatenate([
        jnp.array([params.ball_elasticity], dtype=dtype),
        jnp.full((params.n_players,), params.player_elasticity, dtype=dtype),
    ])


def team_of_body(params: EnvParams) -> jnp.ndarray:
    """[n_bodies] int32: -1 for the ball, 0/1 for players."""
    ppt = params.players_per_team
    return jnp.concatenate([
        jnp.array([-1], dtype=jnp.int32),
        jnp.zeros((ppt,), dtype=jnp.int32),
        jnp.ones((ppt,), dtype=jnp.int32),
    ])
