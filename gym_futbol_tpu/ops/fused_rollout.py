"""Fused T-step rollout as one Pallas kernel on the Triton route.

The XLA path (:func:`gym_futbol_tpu.vector.rollout`) runs each env step
as a ``lax.scan`` body. Inside it, the physics ``fori_loop`` over
``substeps`` wraps a ``fori_loop`` over ``solver_iterations``: about 50
device-loop iterations of tiny ``[B]`` elementwise work per env step,
each of which costs at least one kernel launch on a GPU.

This kernel runs the WHOLE rollout — per-player action sampling, kick
and placement noise, possession, kicks, the sequential-impulse physics,
goals, OOB, rewards, kickoff re-placement and auto-reset — in one
launch. Each program owns ``block`` envs, and every per-body scalar is
one ``[block]`` vector held in registers across all T steps: device
memory is read once for the state, written once for it, and written
once per step for the ``[block]`` reward row.

LAYOUT. The env axis is last::

    statef [4*n_bodies, B] f32   rows: px | py | vx | vy (body order)
    statei [4,          B] i32   rows: possession, score0, score1, t

Rows are loaded and stored one at a time as ``[block]`` vectors at static
row indices, so the row count need not be a power of two (Triton requires
power-of-two tensors; ``block`` is one).

RANDOM NUMBERS. A counter-based generator: each uniform is a uint32 hash
of (seed, global env index, step, draw index) (:func:`uniform01`). The
same code runs in the kernel, in interpret mode and in the tests, and the
stream does not depend on the block size or on how the batch is sharded
(``env_offset`` gives a shard's first global env index).

SEMANTICS. The step pipeline of :func:`gym_futbol_tpu.env.step` with
``auto_reset=True``, built from the same scalar-form functions of
:mod:`gym_futbol_tpu.game` and :mod:`gym_futbol_tpu.physics` (each
"scalar" is a ``[block]`` env vector here). Only the random stream
differs from the jnp path, which threads ``jax.random`` keys: same
distributions, different draws. :func:`fused_rollout_replay` takes
pre-drawn actions and zero noise instead, and matches the jnp path when
``kick_noise == 0`` and ``placement_noise == 0``.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import game
from ..physics import physics_step_scalars
from ..types import EnvParams, EnvState

# Envs per program. One env per GPU thread (block = 32 * num_warps) is
# what keeps each env's state in registers: two envs per thread ran 3.7x
# slower on an H100. 32 envs per program spreads 4096 envs over 128 SMs.
DEFAULT_BLOCK = 32


# ---------------------------------------------------------------------------
# Packing: EnvState (batched, leading env axis) <-> env-last rows
# ---------------------------------------------------------------------------


def pack_state(state: EnvState, params: EnvParams):
    """Batched EnvState ([B, ...] leaves) -> (statef [4n, B], statei [4, B])."""
    del params  # n_bodies follows from the state
    statef = jnp.concatenate([
        state.pos[:, :, 0].T, state.pos[:, :, 1].T,
        state.vel[:, :, 0].T, state.vel[:, :, 1].T,
    ]).astype(jnp.float32)
    statei = jnp.stack([
        state.possession, state.score[:, 0], state.score[:, 1], state.t,
    ]).astype(jnp.int32)
    return statef, statei


def unpack_state(
    statef: jax.Array, statei: jax.Array, key: jax.Array, params: EnvParams
) -> EnvState:
    """Inverse of :func:`pack_state`. ``key`` seeds the jnp-path RNG keys
    of the returned state (one folded key per env)."""
    n = params.n_bodies
    b = statef.shape[1]
    rows = statef.reshape(4, n, b)
    return EnvState(
        pos=jnp.stack([rows[0].T, rows[1].T], axis=-1),
        vel=jnp.stack([rows[2].T, rows[3].T], axis=-1),
        possession=statei[0],
        score=jnp.stack([statei[1], statei[2]], axis=-1),
        t=statei[3],
        key=jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(b)),
    )


# ---------------------------------------------------------------------------
# Counter-based random numbers
# ---------------------------------------------------------------------------


def _mix32(x: jax.Array) -> jax.Array:
    """A bijective uint32 avalanche hash (xor-shift-multiply, 2 rounds)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def env_keys(seed: jax.Array, env_index: jax.Array) -> jax.Array:
    """Per-env uint32 stream key from a seed and GLOBAL env indices."""
    s = _mix32(jnp.asarray(seed).astype(jnp.uint32) ^ jnp.uint32(0x9E3779B9))
    return _mix32(s ^ env_index.astype(jnp.uint32))


def uniform01(env_key: jax.Array, counter: jax.Array) -> jax.Array:
    """Uniform [0, 1) float32 for draw ``counter`` (= step * n_draws +
    draw index) of each env's stream: the top 24 bits of
    ``mix32(env_key ^ mix32(counter))``."""
    c = _mix32(jnp.asarray(counter).astype(jnp.uint32) ^ jnp.uint32(0x85EBCA6B))
    bits = _mix32(env_key ^ c)
    top24 = (bits >> 8).astype(jnp.int32)
    return top24.astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def randint5_from(u):
    """Uniform int32 in [0, 5) from a uniform draw."""
    return jnp.floor(u * 5.0).astype(jnp.int32)


def normal_from(u1, u2):
    """Standard normal via Box-Muller from two uniform draws."""
    u1 = jnp.maximum(u1, jnp.float32(1e-7))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    return r * jnp.cos(jnp.float32(2.0 * math.pi) * u2)


def pm1_from(u):
    """Uniform [-1, 1) f32 from a uniform draw."""
    return u * 2.0 - 1.0


def n_draws_per_step(params: EnvParams) -> int:
    """Uniform draws one fused step consumes: a dir + an act per player,
    two for the Box-Muller kick-noise normal, and an (x, y) placement
    draw per body."""
    return 2 * params.n_players + 2 + 2 * params.n_bodies


# ---------------------------------------------------------------------------
# The fused step (shared by both kernel modes)
# ---------------------------------------------------------------------------


def _fused_step(px, py, vx, vy, possession, score0, score1, t,
                dirs, acts, theta, noise_x, noise_y, params: EnvParams):
    """One env.step(auto_reset=True) on env vectors — the same pipeline as
    gym_futbol_tpu.env.step, built from the same scalar-form functions.
    Returns (new state vectors..., r0/r1 per-team rewards, goal flags,
    done)."""
    dtype = jnp.float32
    n = params.n_bodies
    px_before, py_before = list(px), list(py)

    # 2-4: intent
    fx, fy = game.decode_forces_scalars(dirs, acts, params, dtype)
    possession = game.update_possession_scalars(
        px, py, possession, acts, params, dtype
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

    # 10: kickoff re-placement where a goal occurred
    kox, koy = game.kickoff_scalars(noise_x, noise_y, params, dtype)
    any_goal = goal0 | goal1
    zero = jnp.float32(0.0)
    for i in range(n):
        px[i] = jnp.where(any_goal, kox[i], px[i])
        py[i] = jnp.where(any_goal, koy[i], py[i])
        vx[i] = jnp.where(any_goal, zero, vx[i])
        vy[i] = jnp.where(any_goal, zero, vy[i])
    neg1 = jnp.int32(-1)
    possession = jnp.where(any_goal, neg1, possession)
    score0 = score0 + goal0.astype(jnp.int32)
    score1 = score1 + goal1.astype(jnp.int32)

    # 11: clock + fused auto-reset (reuses this step's kickoff draw,
    # exactly like env.step(auto_reset=True))
    t = t + 1
    done = t >= params.max_steps
    for i in range(n):
        px[i] = jnp.where(done, kox[i], px[i])
        py[i] = jnp.where(done, koy[i], py[i])
        vx[i] = jnp.where(done, zero, vx[i])
        vy[i] = jnp.where(done, zero, vy[i])
    possession = jnp.where(done, neg1, possession)
    score0 = jnp.where(done, 0, score0)
    score1 = jnp.where(done, 0, score1)
    t = jnp.where(done, 0, t)

    return (px, py, vx, vy, possession, score0, score1, t, r0, r1, goal0,
            goal1, done)


def _columns(block: int):
    """This program's env columns: a [block] slice of the env axis."""
    return pl.ds(pl.multiple_of(pl.program_id(0) * block, block), block)


def _run_rollout(params: EnvParams, n_steps: int, cols, inputs_for_step,
                 sf_ref, si_ref, out_sf, out_si, rew_ref):
    """The kernel body shared by both modes: load this program's env
    columns, run ``n_steps`` fused steps with per-step actions and noise
    from ``inputs_for_step(step) -> (dirs, acts, theta, noise_x,
    noise_y)`` ([block] vectors), store each step's reward row and the
    final state."""
    n = params.n_bodies
    state = (
        tuple(sf_ref[i, cols] for i in range(n)),
        tuple(sf_ref[n + i, cols] for i in range(n)),
        tuple(sf_ref[2 * n + i, cols] for i in range(n)),
        tuple(sf_ref[3 * n + i, cols] for i in range(n)),
        si_ref[0, cols], si_ref[1, cols], si_ref[2, cols], si_ref[3, cols],
    )

    def step(step_i, carry):
        px, py, vx, vy = (list(c) for c in carry[:4])
        (px, py, vx, vy, poss, s0, s1, t, r0, _, _, _, _) = _fused_step(
            px, py, vx, vy, *carry[4:], *inputs_for_step(step_i), params,
        )
        rew_ref[step_i, cols] = r0
        return (tuple(px), tuple(py), tuple(vx), tuple(vy), poss, s0, s1, t)

    px, py, vx, vy, poss, s0, s1, t = jax.lax.fori_loop(
        0, n_steps, step, state
    )
    for i in range(n):
        out_sf[i, cols] = px[i]
        out_sf[n + i, cols] = py[i]
        out_sf[2 * n + i, cols] = vx[i]
        out_sf[3 * n + i, cols] = vy[i]
    for r, v in enumerate((poss, s0, s1, t)):
        out_si[r, cols] = v


def _check_batch(b: int, block: int) -> None:
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    if b % block:
        raise ValueError(f"n_envs {b} must be a multiple of block {block}")


def _call(kernel, out_shape, block: int, b: int, interpret: bool,
          name: str):
    """One program per ``block`` envs, one warp per 32 of them."""
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(b // block,),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1,
        ),
        interpret=interpret,
        name=name,
    )


def _out_shapes(n: int, b: int, n_steps: int):
    return [
        jax.ShapeDtypeStruct((4 * n, b), jnp.float32),
        jax.ShapeDtypeStruct((4, b), jnp.int32),
        jax.ShapeDtypeStruct((n_steps, b), jnp.float32),
    ]


# ---------------------------------------------------------------------------
# Random-policy kernel (the bench hot path)
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("params", "n_steps", "block", "interpret"),
    donate_argnames=("statef", "statei"),
)
def fused_rollout(
    statef: jax.Array,
    statei: jax.Array,
    seed: jax.Array,
    params: EnvParams,
    n_steps: int,
    block: int = DEFAULT_BLOCK,
    interpret: bool = False,
    env_offset: jax.Array | int = 0,
):
    """Run ``n_steps`` of uniform-random-policy auto-reset rollout in one
    kernel.

    statef/statei: packed state from :func:`pack_state`. seed: int32
    scalar or [1]. ``env_offset``: the global index of this batch's first
    env (a shard's offset under ``shard_map``). Returns (statef',
    statei', rewards [n_steps, B]): per-step team-0 shaped rewards, the
    quantity ``StepOutput.reward`` reports.
    """
    n = params.n_bodies
    b = statef.shape[1]
    _check_batch(b, block)
    n_draws = n_draws_per_step(params)
    n_players = params.n_players
    counter_base = jnp.stack([
        jnp.asarray(seed, jnp.int32).reshape(-1)[0],
        jnp.asarray(env_offset, jnp.int32),
    ])

    def kernel(key_ref, sf_ref, si_ref, out_sf, out_si, rew_ref):
        cols = _columns(block)
        env_index = (key_ref[1] + pl.program_id(0) * block
                     + jnp.arange(block, dtype=jnp.int32))
        ekey = env_keys(key_ref[0], env_index)

        def inputs_for_step(step_i):
            base = step_i * n_draws
            draws = iter(range(n_draws))
            nxt = lambda: uniform01(ekey, base + next(draws))
            dirs = [randint5_from(nxt()) for _ in range(n_players)]
            acts = [randint5_from(nxt()) for _ in range(n_players)]
            theta = normal_from(nxt(), nxt()) * jnp.float32(params.kick_noise)
            noise_x = [pm1_from(nxt()) for _ in range(n)]
            noise_y = [pm1_from(nxt()) for _ in range(n)]
            return dirs, acts, theta, noise_x, noise_y

        _run_rollout(params, n_steps, cols, inputs_for_step,
                     sf_ref, si_ref, out_sf, out_si, rew_ref)

    fn = _call(kernel, _out_shapes(n, b, n_steps), block, b, interpret,
               "fused_rollout")
    return tuple(fn(counter_base, statef, statei))


# ---------------------------------------------------------------------------
# Replay kernel (deterministic; equivalence testing vs the jnp path)
# ---------------------------------------------------------------------------


def replay_actions(actions: jax.Array) -> jax.Array:
    """[T, B, n_players, 2] int32 actions -> the replay kernel's
    [T, 2*n_players, B] layout (per step, interleaved (dir, act) rows)."""
    t, b = actions.shape[:2]
    return jnp.transpose(actions.reshape(t, b, -1), (0, 2, 1))


@partial(
    jax.jit,
    static_argnames=("params", "block", "interpret"),
)
def fused_rollout_replay(
    statef: jax.Array,
    statei: jax.Array,
    actions: jax.Array,
    params: EnvParams,
    block: int = DEFAULT_BLOCK,
    interpret: bool = False,
):
    """Deterministic fused rollout replaying pre-drawn actions.

    actions: [T, 2*n_players, B] int32 (:func:`replay_actions`). Kick and
    placement noise are zero, so the result matches the jnp path when
    ``params.kick_noise == 0`` and ``params.placement_noise == 0``.
    """
    n = params.n_bodies
    n_steps = actions.shape[0]
    b = statef.shape[1]
    _check_batch(b, block)
    n_players = params.n_players

    def kernel(sf_ref, si_ref, act_ref, out_sf, out_si, rew_ref):
        cols = _columns(block)
        zf = jnp.zeros((block,), jnp.float32)

        def inputs_for_step(step_i):
            dirs = [act_ref[step_i, 2 * p, cols] for p in range(n_players)]
            acts = [act_ref[step_i, 2 * p + 1, cols]
                    for p in range(n_players)]
            return dirs, acts, zf, [zf] * n, [zf] * n

        _run_rollout(params, n_steps, cols, inputs_for_step,
                     sf_ref, si_ref, out_sf, out_si, rew_ref)

    fn = _call(kernel, _out_shapes(n, b, n_steps), block, b, interpret,
               "fused_rollout_replay")
    return tuple(fn(statef, statei, actions))
