"""FULL env.step parity: JAX engine (float64, CPU) vs the C++ oracle.

Extends parity/check_physics_parity.py from the physics kernel to the
WHOLE normative step pipeline (gym_futbol_tpu/env.py STEP ORDER): action
decode, possession bids, pass/shoot kicks, dribble carry, goals, OOB
clamp, shaped rewards, kickoff re-placement, clock and fused auto-reset.

RNG handling: env.step draws theta (kick noise) and kickoff placement
noise from the state's key. This harness replicates the exact key-split
(`k_kick, k_kickoff, k_next = split(state.key, 3)`) and hands the same
draws to the oracle, so both implementations are deterministic functions
of (state, actions, draws) and must agree to float64 roundoff.

Run:  python parity/check_env_parity.py     (CPU, float64)
Exits 0 on pass. :func:`batch_parity` is the same comparison on a batch of
random states stepped at once on whatever device JAX uses (chip_smoke.py
runs it on the GPU).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import env as env_core  # noqa: E402
from gym_futbol_tpu.types import (  # noqa: E402
    EnvParams,
    EnvState,
    RewardConfig,
)
from native.build import load_oracle, oracle_env_step  # noqa: E402

TOL = 1e-9  # float64 max abs error, every state field and reward


def striker_actions(pos, possession, params, rng):
    """Mix of scripted striker (forces possession/kick/goal events) and
    random actions so every step-pipeline branch is exercised."""
    n_players = params.n_players
    acts = rng.randint(0, 5, size=(n_players, 2))
    # player 0 plays striker
    ball, me = pos[0], pos[1]
    d = ball - me
    if abs(d[0]) > abs(d[1]):
        dir_ = 2 if d[0] > 0 else 4
    else:
        dir_ = 1 if d[1] > 0 else 3
    if int(possession) == 1:
        acts[0] = (2, 4 if me[0] > 0.6 * params.width else 1)
    elif float(np.hypot(*d)) <= params.possession_radius:
        acts[0] = (dir_, 2)
    else:
        acts[0] = (dir_, 1)
    return acts.astype(np.int32)


def run_case(lib, params: EnvParams, seed: int, n_steps: int,
             auto_reset: bool) -> tuple[float, int, int]:
    """Lockstep single-step parity from a shared state each step.
    Returns (max_err, n_goals_seen, n_dones_seen)."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    state, _ = env_core.reset(k0, params, dtype=jnp.float64)

    step = jax.jit(
        lambda s, a: env_core.step(s, a, params, auto_reset=auto_reset),
        static_argnums=(),
    )

    max_err, goals, dones = 0.0, 0, 0
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    poss, score, t = int(state.possession), np.zeros(2, np.int32), 0
    cur_key = state.key
    n = params.n_bodies

    for _ in range(n_steps):
        actions = striker_actions(pos, poss, params, rng)

        # jnp path from the SAME state (oracle state re-injected)
        st = EnvState(
            pos=jnp.asarray(pos), vel=jnp.asarray(vel),
            possession=jnp.asarray(poss, jnp.int32),
            score=jnp.asarray(score, jnp.int32),
            t=jnp.asarray(t, jnp.int32), key=cur_key,
        )
        st2, out = step(st, jnp.asarray(actions))

        # replicate env.step's draws for the oracle
        k_kick, k_kickoff, k_next = jax.random.split(cur_key, 3)
        theta = float(
            jax.random.normal(k_kick, (), jnp.float64) * params.kick_noise
        )
        noise = np.asarray(
            jax.random.uniform(k_kickoff, (n, 2), jnp.float64, -1.0, 1.0)
        )
        pos, vel, poss, score, t, reward, done = oracle_env_step(
            lib, pos, vel, poss, score, t, actions, theta, noise, params,
            auto_reset=auto_reset,
        )

        err = max(
            np.abs(np.asarray(st2.pos) - pos).max(),
            np.abs(np.asarray(st2.vel) - vel).max(),
            np.abs(np.asarray(out.team_reward) - reward).max(),
            abs(int(st2.possession) - poss),
            np.abs(np.asarray(st2.score) - score).max(),
            abs(int(st2.t) - t),
            abs(int(bool(out.done)) - int(done)),
        )
        max_err = max(max_err, float(err))
        goals += int(np.asarray(out.info["goal"]).sum())
        dones += int(bool(out.done))
        cur_key = k_next

    return max_err, goals, dones


def random_states(key, params: EnvParams, n: int, dtype=jnp.float64):
    """``n`` random mid-game states and joint actions: bodies anywhere on
    (and a little beyond) the field, velocities up to half max speed,
    any owner, scores, clocks (a quarter one step from the time limit).
    One state in eight has a loose ball shooting into a goal mouth."""
    nb, npl = params.n_bodies, params.n_players
    k = jax.random.split(key, 8)
    scale = jnp.asarray([params.width, params.height], dtype)
    pos = jax.random.uniform(k[0], (n, nb, 2), dtype, -0.02, 1.02) * scale
    vel = jax.random.uniform(k[1], (n, nb, 2), dtype, -0.5, 0.5)
    vel = vel * params.max_speed
    poss = jax.random.randint(k[2], (n,), 0, npl + 1)
    t = jax.random.randint(k[3], (n,), 0, params.max_steps)
    idx = jnp.arange(n)
    t = jnp.where(idx % 4 == 0, params.max_steps - 1, t)
    # shots: ball 5 units inside a goal line, in the mouth, flying out
    right = idx % 16 == 1
    shot = right | (idx % 16 == 9)
    mouth_y = params.height / 2 + (pos[:, 0, 1] / params.height - 0.5) * (
        params.goal_size / 2)
    ball_pos = jnp.stack([jnp.where(right, params.width - 5.0, 5.0),
                          mouth_y], axis=-1)
    ball_vel = jnp.stack([jnp.where(right, 1.0, -1.0) * params.max_speed / 2,
                          jnp.zeros_like(mouth_y)], axis=-1)
    pos = pos.at[:, 0].set(jnp.where(shot[:, None], ball_pos, pos[:, 0]))
    vel = vel.at[:, 0].set(jnp.where(shot[:, None], ball_vel, vel[:, 0]))
    poss = jnp.where(shot, 0, poss)
    state = EnvState(
        pos=pos, vel=vel,
        possession=jnp.where(poss == 0, -1, poss).astype(jnp.int32),
        score=jax.random.randint(k[4], (n, 2), 0, 3, jnp.int32),
        t=t.astype(jnp.int32),
        key=jax.random.split(k[5], n),
    )
    actions = jax.random.randint(k[6], (n, npl, 2), 0, 5, jnp.int32)
    return state, actions


def batch_parity(lib, params: EnvParams, n_states: int, seed: int = 0
                 ) -> dict:
    """Step ``n_states`` random states once, all at once, with the jnp
    ``env.step(auto_reset=True)`` in float64 on JAX's default device, and
    each with the oracle on the host from the same state, actions and
    draws. Needs ``jax_enable_x64``. Returns the max abs error over every
    field and the goals and dones exercised."""
    n = params.n_bodies
    state, actions = random_states(jax.random.PRNGKey(seed), params,
                                   n_states)
    step = jax.jit(jax.vmap(
        lambda s, a: env_core.step(s, a, params, auto_reset=True)
    ))

    def draws(key):
        k_kick, k_kickoff, _ = jax.random.split(key, 3)
        theta = jax.random.normal(k_kick, (), jnp.float64) * params.kick_noise
        noise = jax.random.uniform(k_kickoff, (n, 2), jnp.float64, -1.0, 1.0)
        return theta, noise

    st2, out = step(state, actions)
    theta, noise = jax.jit(jax.vmap(draws))(state.key)
    assert st2.pos.dtype == jnp.float64, "batch_parity needs jax_enable_x64"
    host = jax.device_get((state, actions, st2, out, theta, noise))
    state, actions, st2, out, theta, noise = host
    max_err = 0.0
    for i in range(n_states):
        pos, vel, poss, score, t, reward, done = oracle_env_step(
            lib, state.pos[i], state.vel[i], int(state.possession[i]),
            state.score[i], int(state.t[i]), actions[i], float(theta[i]),
            noise[i], params, auto_reset=True,
        )
        err = max(
            np.abs(st2.pos[i] - pos).max(),
            np.abs(st2.vel[i] - vel).max(),
            np.abs(out.team_reward[i] - reward).max(),
            abs(int(st2.possession[i]) - poss),
            np.abs(st2.score[i] - score).max(),
            abs(int(st2.t[i]) - t),
            abs(int(bool(out.done[i])) - int(done)),
        )
        max_err = max(max_err, float(err))
    return {
        "max_err": max_err,
        "goals": int(np.asarray(out.info["goal"]).sum()),
        "dones": int(np.asarray(out.done).sum()),
    }


def main() -> int:
    from gym_futbol_tpu.utils.cache import enable_compilation_cache

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    lib = load_oracle()
    cases = [
        ("1v1 striker", EnvParams(players_per_team=1, max_steps=80), 200, True),
        ("2v2 striker", EnvParams(players_per_team=2, max_steps=80), 200, True),
        ("3v3 random", EnvParams(players_per_team=3, max_steps=60), 120, True),
        ("2v2 no-autoreset", EnvParams(players_per_team=2, max_steps=50), 60,
         False),
        # NON-DEFAULT geometry/material/integration constants (VERDICT r4
        # weak #5): registry.make's override surface is first-class
        # (docs/MIGRATION.md §1) — a constant accidentally baked into the
        # jnp step instead of read from EnvParams passes every default
        # case and fails exactly here.
        ("2v2 custom-geometry", EnvParams(
            players_per_team=2, max_steps=80,
            width=900.0, height=300.0, goal_size=60.0,
            player_radius=12.0, ball_radius=14.0,
            player_mass=35.0, ball_mass=2.5,
            player_elasticity=0.5, ball_elasticity=0.3,
            wall_elasticity=0.95, friction=0.7,
            dt=0.08, substeps=7, damping=0.9, solver_iterations=6,
            collision_slop=0.05, baumgarte=0.3, max_speed=350.0,
        ), 200, True),
        # NON-DEFAULT action/reward constants: custom RewardConfig plus
        # kick powers / possession reach / kickoff jitter overrides.
        ("2v2 custom-rewards", EnvParams(
            players_per_team=2, max_steps=70,
            move_force=3500.0, dash_multiplier=1.5,
            possession_radius=55.0, dribble_offset=5.0,
            pass_power=450.0, shoot_power=900.0, kick_noise=0.12,
            placement_noise=0.06,
            rewards=RewardConfig(
                goal=25.0, concede=-5.0, ball_to_goal_delta=0.37,
                player_to_ball_delta=0.045, possession_bonus=0.013,
                oob_penalty=-0.55, time_penalty=-0.002,
            ),
        ), 200, True),
    ]
    failures = 0
    for name, params, steps, auto in cases:
        worst, goals, dones = 0.0, 0, 0
        for seed in range(3):
            e, gseen, dseen = run_case(lib, params, seed, steps, auto)
            worst = max(worst, e)
            goals += gseen
            dones += dseen
        ok = worst < TOL
        failures += 0 if ok else 1
        print(f"{'OK ' if ok else 'FAIL'} {name}: max err {worst:.3e} "
              f"(gate {TOL:g}) over {steps} steps x3 seeds; "
              f"events: {goals} goals, {dones} dones")
        if goals == 0 and "striker" in name:
            print(f"WARN {name}: no goals exercised")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
