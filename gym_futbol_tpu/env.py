"""FutbolEnv — the environment API.

The reference exposes the classic OpenAI-Gym class surface
(``FutbolEnv.reset/step/render`` with ``action_space``/``observation_space``
— SURVEY.md §2.1 #2). This module provides BOTH:

- the pure-functional core (:func:`reset`, :func:`step`) — the real API,
  jit/vmap/shard_map-able, everything downstream builds on it;
- :class:`FutbolEnv`, a thin stateful wrapper with the Gym calling
  convention for drop-in ergonomics (single env, host-side loop).

STEP ORDER (normative — the C++ oracle replicates this exactly):

    1. split RNG key -> (kick_key, next_key)
    2. decode actions -> per-body forces               (game.decode_forces)
    3. resolve possession bids                          (game.update_possession)
    4. owner pass/shoot -> ball impulse, release        (game.apply_kick)
    5. physics: substeps x (integrate, solve, move)     (physics.physics_step)
    6. dribble carry: ball follows owner                (game.apply_dribble)
    7. goal detection on the post-physics ball          (game.detect_goal)
    8. out-of-bounds clamp                              (game.clamp_oob)
    9. shaped rewards (uses pre-step vs post-step, pre-kickoff positions)
   10. scoring kickoff re-placement where a goal occurred (masked select)
   11. t += 1; done = t >= max_steps
   12. observation build

OBSERVATION SPEC (normative): flat float vector, length 4*n_bodies + 2:
``[x, y, vx, vy]`` per body (ball first), positions normalized by field
width/height, velocities by max_speed, then ``[team0_owns, team1_owns]``.
(SURVEY.md §2.1 #9 tags the reference's exact layout [RECALL-M]; this is
our spec.)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import game
from .physics import physics_step_scalars
from .spaces import Box, MultiDiscrete
from .types import EnvParams, EnvState, StepOutput


def observe(state: EnvState, params: EnvParams) -> jax.Array:
    """OBSERVATION SPEC above."""
    dtype = state.pos.dtype
    scale_p = jnp.asarray([params.width, params.height], dtype)
    p = (state.pos / scale_p).reshape(-1)
    v = (state.vel / jnp.asarray(params.max_speed, dtype)).reshape(-1)
    ppt = params.players_per_team
    owner_p = state.possession - 1
    owns0 = ((state.possession > 0) & (owner_p < ppt)).astype(dtype)
    owns1 = ((state.possession > 0) & (owner_p >= ppt)).astype(dtype)
    return jnp.concatenate([p, v, jnp.stack([owns0, owns1])])


def obs_size(params: EnvParams) -> int:
    return 4 * params.n_bodies + 2


def mirror_obs(obs: jax.Array, params: EnvParams) -> jax.Array:
    """Present team 1 with a team-0 view: mirror x about the field center
    and swap the team blocks, so ONE policy can play either side. This is
    the symmetry that makes per-team self-play training work (the learner
    only ever sees the world from 'my goal is on the left').

    Self-inverse: ``mirror_obs(mirror_obs(o)) == o``.

    Obs layout (OBSERVATION SPEC above): ALL positions first
    ([x0, y0, x1, y1, ...], normalized), then all velocities, then the 2
    possession flags — NOT interleaved per body.
    """
    n = params.n_bodies
    ppt = params.players_per_team

    def reorder_pairs(block, negate_x: bool, one_minus_x: bool):
        # block [.., 2n] of per-body (x, y) pairs -> mirrored + team-swapped
        pairs = block.reshape(block.shape[:-1] + (n, 2))
        x = pairs[..., 0]
        if one_minus_x:
            x = 1.0 - x
        if negate_x:
            x = -x
        pairs = jnp.stack([x, pairs[..., 1]], axis=-1)
        ball = pairs[..., :1, :]
        t0 = pairs[..., 1 : 1 + ppt, :]
        t1 = pairs[..., 1 + ppt : 1 + 2 * ppt, :]
        pairs = jnp.concatenate([ball, t1, t0], axis=-2)
        return pairs.reshape(block.shape)

    pos = reorder_pairs(obs[..., : 2 * n], negate_x=False, one_minus_x=True)
    vel = reorder_pairs(
        obs[..., 2 * n : 4 * n], negate_x=True, one_minus_x=False
    )
    flags = obs[..., 4 * n :]
    flags = jnp.stack([flags[..., 1], flags[..., 0]], axis=-1)
    return jnp.concatenate([pos, vel, flags], axis=-1)


def mirror_actions(actions: jax.Array) -> jax.Array:
    """Map team actions between the mirrored frame and the world frame:
    swap the left/right direction choices (2 <-> 4) in slot 0. The act
    slot is frame-independent (targets are chosen from positions).
    Self-inverse. ``actions``: [.., n, 2] int32 per the ACTION SPEC.
    """
    dirs = actions[..., 0]
    dirs = jnp.where(dirs == 2, 4, jnp.where(dirs == 4, 2, dirs))
    return actions.at[..., 0].set(dirs)


def reset(
    key: jax.Array, params: EnvParams, dtype=jnp.float32
) -> tuple[EnvState, jax.Array]:
    """Fresh episode (SURVEY.md §3.2). Returns (state, obs)."""
    k_place, k_state = jax.random.split(key)
    pos, vel = game.kickoff_positions(k_place, params, dtype)
    state = EnvState(
        pos=pos,
        vel=vel,
        possession=jnp.asarray(-1, jnp.int32),
        score=jnp.zeros((2,), jnp.int32),
        t=jnp.asarray(0, jnp.int32),
        key=k_state,
    )
    return state, observe(state, params)


@partial(jax.jit, static_argnames=("params", "auto_reset"))
def step(
    state: EnvState, actions: jax.Array, params: EnvParams,
    auto_reset: bool = False,
) -> tuple[EnvState, StepOutput]:
    """One environment step (STEP ORDER above). ``actions``: [n_players, 2]
    int32 per the ACTION SPEC in :mod:`gym_futbol_tpu.game`.

    With ``auto_reset=True`` (the vectorized/training path), wherever
    ``done`` is hit the carried state is replaced by a fresh episode in
    the same fused program, REUSING this step's kickoff placement draw —
    no extra RNG or reset work. ``reward``/``done``/``info`` report the
    terminal transition; ``obs`` follows the carried state (post-reset
    where done), matching classic vec-env autoreset semantics: the policy
    always acts on an observation consistent with the carried state, and
    ``done`` cuts the value bootstrap so the terminal obs is not needed.
    """
    dtype = state.pos.dtype
    n = params.n_bodies
    k_kick, k_kickoff, k_next = jax.random.split(state.key, 3)

    # Unpack ONCE into per-body coordinate scalars; the whole step then
    # runs in scalar-SSA form — under vmap every scalar is a dense [B]
    # vector, so no [B, n_bodies, 2] gathers/scatters appear anywhere in
    # the hot path.
    px = [state.pos[i, 0] for i in range(n)]
    py = [state.pos[i, 1] for i in range(n)]
    vx = [state.vel[i, 0] for i in range(n)]
    vy = [state.vel[i, 1] for i in range(n)]
    px_before, py_before = list(px), list(py)

    # 2-4: intent
    dirs, acts = game.split_actions(actions, params)
    fx, fy = game.decode_forces_scalars(dirs, acts, params, dtype)
    possession = game.update_possession_scalars(
        px, py, state.possession, acts, params, dtype
    )
    theta = jax.random.normal(k_kick, (), dtype) * jnp.asarray(
        params.kick_noise, dtype
    )
    dvx, dvy, possession = game.apply_kick_scalars(
        px, py, vx, vy, possession, acts, theta, params, dtype
    )
    vx[0] = vx[0] + dvx
    vy[0] = vy[0] + dvy

    # 5-6: dynamics
    px, py, vx, vy = physics_step_scalars(
        px, py, vx, vy, fx, fy, params, dtype
    )
    px[0], py[0], vx[0], vy[0] = game.apply_dribble_scalars(
        px, py, vx, vy, possession, dirs, params, dtype
    )

    # 7-8: goals and bounds
    goal0, goal1 = game.detect_goal_scalars(px[0], py[0], params)
    px, py, vx, vy, ball_clamped = game.clamp_oob_scalars(
        px, py, vx, vy, params, dtype
    )

    # 9: rewards from pre-kickoff positions
    r0, r1 = game.shaped_rewards_scalars(
        px_before, py_before, px, py, possession, goal0, goal1,
        ball_clamped, params, dtype,
    )
    team_reward = jnp.stack([r0, r1])
    goals = jnp.stack([goal0, goal1])

    # pack once at the end of the scalar pipeline
    pos = jnp.stack([jnp.stack(px), jnp.stack(py)], axis=-1)
    vel = jnp.stack([jnp.stack(vx), jnp.stack(vy)], axis=-1)

    # 10: kickoff re-placement where a goal occurred (masked select)
    any_goal = goal0 | goal1
    kick_pos, kick_vel = game.kickoff_positions(k_kickoff, params, dtype)
    pos = jnp.where(any_goal, kick_pos, pos)
    vel = jnp.where(any_goal, kick_vel, vel)
    possession = jnp.where(any_goal, jnp.asarray(-1, jnp.int32), possession)
    score = state.score + goals.astype(jnp.int32)

    # 11: clock
    t = state.t + 1
    done = t >= params.max_steps

    if auto_reset:
        # Fresh episode where done: a new episode's initial state IS a
        # kickoff placement, so reuse (kick_pos, kick_vel) drawn above.
        new_state = EnvState(
            pos=jnp.where(done, kick_pos, pos),
            vel=jnp.where(done, kick_vel, vel),
            possession=jnp.where(done, jnp.asarray(-1, jnp.int32), possession),
            score=jnp.where(done, jnp.zeros((2,), jnp.int32), score),
            t=jnp.where(done, jnp.asarray(0, jnp.int32), t),
            key=k_next,
        )
    else:
        new_state = EnvState(
            pos=pos, vel=vel, possession=possession, score=score, t=t,
            key=k_next,
        )
    obs = observe(new_state, params)
    out = StepOutput(
        obs=obs,
        reward=team_reward[0],
        team_reward=team_reward,
        done=done,
        info={
            "score": score,
            "possession": possession,
            "goal": goals,
            "ball_oob": ball_clamped,
            "t": t,
        },
    )
    return new_state, out


# ---------------------------------------------------------------------------
# Gym-style wrapper (single env, host loop)
# ---------------------------------------------------------------------------


class FutbolEnv:
    """Stateful Gym-convention wrapper over the pure core.

    Mirrors the reference's class surface (SURVEY.md §2.1 #2):
    ``reset() -> obs``; ``step(a) -> (obs, reward, done, info)``;
    ``render()``; ``action_space``; ``observation_space``. For throughput
    use :mod:`gym_futbol_tpu.vector` instead — this wrapper exists for
    ergonomic parity and debugging.
    """

    def __init__(self, params: EnvParams | None = None, seed: int = 0,
                 dtype=jnp.float32):
        self.params = params or EnvParams()
        self.dtype = dtype
        self._key = jax.random.PRNGKey(seed)
        self._state: EnvState | None = None
        n_players = self.params.n_players
        self.action_space = MultiDiscrete([[5, 5]] * n_players)
        self.observation_space = Box(
            -jnp.inf, jnp.inf, shape=(obs_size(self.params),), dtype=dtype
        )

    def seed(self, seed: int) -> None:
        self._key = jax.random.PRNGKey(seed)

    def reset(self):
        self._key, k = jax.random.split(self._key)
        self._state, obs = reset(k, self.params, self.dtype)
        return obs

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        actions = jnp.asarray(actions, jnp.int32)
        self._state, out = step(self._state, actions, self.params)
        return out.obs, out.reward, bool(out.done), jax.tree.map(
            lambda x: x, out.info
        )

    @property
    def state(self) -> EnvState:
        return self._state

    def render(self, mode: str = "rgb_array"):
        from .render import render_state

        return render_state(self._state, self.params, mode=mode)
