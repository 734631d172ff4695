"""Fused Triton-route rollout kernel vs the jnp path (interpret mode on CPU).

The replay kernel injects zero kick/placement noise, so with
``kick_noise == 0`` and ``placement_noise == 0`` the two paths compute
the identical step pipeline from the identical scalar-form functions —
trajectories must agree to float32 roundoff (same formulas, same order).
The random-policy kernel draws from a counter-based hash generator that
runs the same in interpret mode, so it is tested here too.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_futbol_tpu import EnvParams
from gym_futbol_tpu import env as env_core
from gym_futbol_tpu.ops import (
    fused_rollout,
    fused_rollout_replay,
    pack_state,
    replay_actions,
    unpack_state,
)
from gym_futbol_tpu.ops.fused_rollout import (
    DEFAULT_BLOCK,
    env_keys,
    normal_from,
    randint5_from,
    uniform01,
)
from gym_futbol_tpu.vector import STATE_AXES, random_policy, reset_batch, rollout

# Zero noise => both paths deterministic given actions. max_steps small so
# the rollout crosses auto-reset boundaries.
P = EnvParams(
    players_per_team=2, kick_noise=0.0, placement_noise=0.0,
    substeps=2, solver_iterations=4, max_steps=6,
)
B, T = 64, 9
BLOCK = 32


def _jnp_replay(state, actions, params):
    """Reference rollout replaying recorded actions [T, B, n_players, 2]."""
    def body(state, a):
        state, out = jax.vmap(
            lambda s, aa: env_core.step(s, aa, params, auto_reset=True),
            in_axes=(STATE_AXES, 0), out_axes=(STATE_AXES, 0),
        )(state, a)
        return state, out
    return jax.lax.scan(body, state, actions)


def _check_replay(params, state, actions, block=BLOCK):
    ref_state, ref_out = _jnp_replay(state, actions, params)
    sf, si = pack_state(state, params)
    sf2, si2, rew = fused_rollout_replay(
        sf, si, replay_actions(actions), params, block=block, interpret=True
    )
    got = unpack_state(sf2, si2, jax.random.PRNGKey(0), params)
    np.testing.assert_allclose(
        np.asarray(rew), np.asarray(ref_out.reward), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(got.pos), np.asarray(ref_state.pos), rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(got.vel), np.asarray(ref_state.vel), rtol=1e-4, atol=1e-3,
    )
    for field in ("possession", "score", "t"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(ref_state, field))
        )


def _actions(key, params, b=B, t=T):
    return jax.random.randint(key, (t, b, params.n_players, 2), 0, 5,
                              dtype=jnp.int32)


@pytest.fixture(scope="module")
def setup():
    state, _ = reset_batch(jax.random.PRNGKey(7), P, B)
    return state, _actions(jax.random.PRNGKey(3), P)


class TestReplayEquivalence:
    def test_matches_jnp_path(self, setup):
        state, actions = setup
        _check_replay(P, state, actions)

    @pytest.mark.parametrize("ppt", [1, 2, 3])
    def test_matches_jnp_path_across_team_sizes(self, ppt):
        p = P.replace(players_per_team=ppt)
        state, _ = reset_batch(jax.random.PRNGKey(ppt), p, B)
        _check_replay(p, state, _actions(jax.random.PRNGKey(10 + ppt), p))

    def test_matches_jnp_path_custom_params(self):
        """NON-DEFAULT geometry/material/action/reward constants through
        the kernel (interpret): a constant baked into the KERNEL path
        instead of read from EnvParams passes every default-params replay
        test and fails exactly here."""
        from gym_futbol_tpu import RewardConfig

        p = EnvParams(
            players_per_team=2, kick_noise=0.0, placement_noise=0.0,
            substeps=3, solver_iterations=5, max_steps=7,
            width=900.0, height=300.0, goal_size=60.0,
            player_radius=12.0, ball_radius=14.0,
            player_mass=35.0, ball_mass=2.5,
            player_elasticity=0.5, ball_elasticity=0.3,
            wall_elasticity=0.95, friction=0.7,
            dt=0.08, damping=0.9, collision_slop=0.05,
            baumgarte=0.3, max_speed=350.0,
            move_force=3500.0, dash_multiplier=1.5,
            possession_radius=55.0, dribble_offset=5.0,
            pass_power=450.0, shoot_power=900.0,
            rewards=RewardConfig(
                goal=25.0, concede=-5.0, ball_to_goal_delta=0.37,
                player_to_ball_delta=0.045, possession_bonus=0.013,
                oob_penalty=-0.55, time_penalty=-0.002,
            ),
        )
        state, _ = reset_batch(jax.random.PRNGKey(11), p, B)
        _check_replay(p, state, _actions(jax.random.PRNGKey(13), p))

    def test_block_size_does_not_change_result(self, setup):
        state, actions = setup
        sf, si = pack_state(state, P)
        acts = replay_actions(actions)
        a = fused_rollout_replay(sf, si, acts, P, block=16, interpret=True)
        b = fused_rollout_replay(sf, si, acts, P, block=64, interpret=True)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_pack_unpack_roundtrip(self, setup):
        state, _ = setup
        sf, si = pack_state(state, P)
        assert sf.shape == (4 * P.n_bodies, B) and si.shape == (4, B)
        back = unpack_state(sf, si, jax.random.PRNGKey(0), P)
        for field in ("pos", "vel", "possession", "score", "t"):
            np.testing.assert_array_equal(
                np.asarray(getattr(back, field)),
                np.asarray(getattr(state, field)),
            )

    def test_replay_actions_layout(self, setup):
        _, actions = setup
        acts = replay_actions(actions)
        assert acts.shape == (T, 2 * P.n_players, B)
        np.testing.assert_array_equal(
            np.asarray(acts[4, 2 * 3 + 1, 17]), np.asarray(actions[4, 17, 3, 1])
        )


class TestCounterPRNG:
    """The kernel's counter-based generator (ops.fused_rollout.uniform01):
    a pure function of (seed, global env index, step, draw index)."""

    N_ENV, N_CTR = 256, 64

    def _grid(self, seed=1):
        keys = env_keys(jnp.int32(seed), jnp.arange(self.N_ENV))
        ctr = jnp.arange(self.N_CTR)
        return jax.vmap(lambda c: uniform01(keys, c))(ctr)  # [ctr, env]

    def test_deterministic_and_in_range(self):
        a, b = np.asarray(self._grid()), np.asarray(self._grid())
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and a.min() >= 0.0 and a.max() < 1.0

    @pytest.mark.parametrize("axis", ["seed", "env", "step", "draw"])
    def test_independent_along_each_axis(self, axis):
        """Changing one coordinate gives a fresh, uncorrelated stream."""
        n_draws = 8
        base = dict(seed=1, env=jnp.arange(512), step=3, draw=2)
        moved = dict(base)
        if axis == "seed":
            moved["seed"] = 2
        elif axis == "env":
            moved["env"] = jnp.arange(512) + 512
        elif axis == "step":
            moved["step"] = 4
        else:
            moved["draw"] = 3

        def draw(c):
            keys = env_keys(jnp.int32(c["seed"]), c["env"])
            return np.asarray(uniform01(keys, c["step"] * n_draws + c["draw"]))

        a, b = draw(base), draw(moved)
        assert (a != b).mean() > 0.99
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.15

    def test_randint5_uniform(self):
        x = np.asarray(randint5_from(self._grid())).ravel()
        counts = np.bincount(x, minlength=5)
        assert counts.size == 5
        expected = x.size / 5
        chi2 = ((counts - expected) ** 2 / expected).sum()
        assert chi2 < 20.0, counts      # 4 dof: p ~ 5e-4

    def test_normal_moments(self):
        g = np.asarray(self._grid())
        z = np.asarray(normal_from(g[0::2], g[1::2])).ravel()
        assert abs(z.mean()) < 0.03 and abs(z.std() - 1.0) < 0.03
        assert abs((z ** 3).mean()) < 0.1 and abs((z ** 4).mean() - 3) < 0.2

    def test_uniform_fills_unit_interval(self):
        u = np.asarray(self._grid()).ravel()
        hist, _ = np.histogram(u, bins=16, range=(0.0, 1.0))
        expected = u.size / 16
        assert ((hist - expected) ** 2 / expected).sum() < 45.0  # 15 dof


class TestRandomMode:
    def test_random_rollout_interpret(self, setup):
        """Random-policy kernel: auto-reset clock stays in range, rewards
        finite, scores sane, actions vary."""
        state, _ = setup
        sf, si = pack_state(state, P)
        sf2, si2, rew = fused_rollout(
            sf, si, 42, P, n_steps=T, block=BLOCK, interpret=True,
        )
        rew, si2 = np.asarray(rew), np.asarray(si2)
        assert rew.shape == (T, B)
        assert np.isfinite(rew).all() and np.isfinite(np.asarray(sf2)).all()
        assert ((si2[3] >= 0) & (si2[3] < P.max_steps)).all()
        assert (si2[1] >= 0).all() and (si2[2] >= 0).all()
        assert np.abs(rew).sum() > 0

    def test_statistics_match_jnp_random_policy(self):
        """Same distributions as the jnp random policy: per-env mean
        reward and final scores agree within 4 standard errors."""
        p = EnvParams(players_per_team=1, substeps=2, solver_iterations=3)
        b, t = 256, 40
        state, _ = reset_batch(jax.random.PRNGKey(5), p, b)
        sf, si = pack_state(state, p)
        _, si2, rew = fused_rollout(sf, si, 3, p, n_steps=t, interpret=True)
        ref_state, outs = rollout(state, random_policy(p),
                                  jax.random.PRNGKey(4), p, t)
        pairs = [
            (np.asarray(rew).mean(0), np.asarray(outs.reward).mean(0)),
            (np.asarray(si2[1]), np.asarray(ref_state.score[:, 0])),
            (np.asarray(si2[2]), np.asarray(ref_state.score[:, 1])),
        ]
        for a, r in pairs:
            se = np.sqrt(a.var() / a.size + r.var() / r.size)
            assert abs(a.mean() - r.mean()) <= 4 * se + 1e-9, (a.mean(), r.mean())
        np.testing.assert_array_equal(np.asarray(si2[3]),
                                      np.asarray(ref_state.t))


class TestCounterRandomMode:
    def test_seed_determines_stream(self, setup):
        """Same seed -> identical trajectory; different seed -> different."""
        state, _ = setup
        run = lambda seed: fused_rollout(*pack_state(state, P), seed, P,
                                         n_steps=T, interpret=True)
        a1, a2, b1 = run(7), run(7), run(8)
        np.testing.assert_array_equal(np.asarray(a1[0]), np.asarray(a2[0]))
        np.testing.assert_array_equal(np.asarray(a1[2]), np.asarray(a2[2]))
        assert not np.array_equal(np.asarray(a1[0]), np.asarray(b1[0]))

    def test_env_offset_selects_global_streams(self, setup):
        """Running envs [32, 64) alone with env_offset=32 reproduces the
        same envs of the full batch: streams follow global env indices."""
        state, _ = setup
        full = fused_rollout(*pack_state(state, P), 5, P, n_steps=T,
                             interpret=True)
        sf, si = pack_state(state, P)  # the call above donated its inputs
        half = fused_rollout(sf[:, 32:], si[:, 32:], 5, P, n_steps=T,
                             interpret=True, env_offset=32)
        for f, h in zip(full, half):
            np.testing.assert_array_equal(np.asarray(f)[:, 32:],
                                          np.asarray(h))

    def test_sharded_streams_decorrelated(self):
        """shard_fused_rollout gives each shard its global env indices;
        shards holding identical states must diverge."""
        from gym_futbol_tpu.parallel import make_mesh, shard_fused_rollout

        mesh = make_mesh()
        n_dev = len(mesh.devices.flat)
        state, _ = reset_batch(jax.random.PRNGKey(5), P, BLOCK)
        sf, si = pack_state(state, P)
        sf, si = jnp.tile(sf, (1, n_dev)), jnp.tile(si, (1, n_dev))
        run = shard_fused_rollout(mesh, P, n_steps=T, block=BLOCK,
                                  interpret=True)
        sf2, si2, rew = run(sf, si, jnp.asarray(3, jnp.int32))
        assert np.isfinite(np.asarray(rew)).all()
        shards = np.asarray(sf2).reshape(-1, n_dev, BLOCK)
        for i in range(n_dev):
            for j in range(i + 1, n_dev):
                assert not np.array_equal(shards[:, i], shards[:, j]), (
                    f"shards {i} and {j} identical"
                )


class TestShardedFused:
    def test_sharded_replay_matches_unsharded(self, setup):
        """The replay kernel under shard_map over the 8-device 'env' mesh
        computes the same trajectory as the unsharded kernel."""
        from jax.sharding import PartitionSpec as Spec

        from gym_futbol_tpu.parallel import make_mesh

        state, actions = setup
        mesh = make_mesh()
        n_dev = len(mesh.devices.flat)
        reps = n_dev * BLOCK // B
        sf, si = pack_state(state, P)
        acts = replay_actions(actions)
        ref = fused_rollout_replay(sf, si, acts, P, interpret=True)
        cols = Spec(None, "env")
        mapped = jax.jit(jax.shard_map(
            lambda a, b, c: fused_rollout_replay(a, b, c, P, interpret=True),
            mesh=mesh,
            in_specs=(cols, cols, Spec(None, None, "env")),
            out_specs=(cols, cols, cols),
            check_vma=False,
        ))
        got = mapped(jnp.tile(sf, (1, reps)), jnp.tile(si, (1, reps)),
                     jnp.tile(acts, (1, 1, reps)))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(
                np.asarray(g), np.tile(np.asarray(r), (1, reps)),
                rtol=1e-6, atol=1e-6,
            )


class TestWrapper:
    def test_block_must_be_power_of_two(self, setup):
        state, actions = setup
        sf, si = pack_state(state, P)
        with pytest.raises(ValueError, match="power of two"):
            fused_rollout_replay(sf, si, replay_actions(actions), P,
                                 block=24, interpret=True)

    def test_batch_must_divide(self, setup):
        state, _ = setup
        sf, si = pack_state(state, P)
        with pytest.raises(ValueError, match="multiple of block"):
            fused_rollout(sf[:, :48], si[:, :48], 1, P, n_steps=2,
                          block=32, interpret=True)

    def test_interpret_defaults_off(self):
        for fn in (fused_rollout, fused_rollout_replay):
            sig = inspect.signature(inspect.unwrap(fn))
            assert sig.parameters["interpret"].default is False
            assert sig.parameters["block"].default == DEFAULT_BLOCK

    def test_lowers_to_triton_for_cuda(self, setup):
        """The kernel lowers through Pallas' Triton route for a CUDA
        target (cross-lowered here; compiled only on the card)."""
        state, _ = setup
        sf, si = pack_state(state, P)
        lowered = fused_rollout.trace(sf, si, 1, P, 2).lower(
            lowering_platforms=("cuda",)
        )
        assert "xla.gpu.triton" in lowered.as_text()


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu(gpu, setup):
    """On the card: the compiled (not interpreted) replay kernel matches
    the jnp step (chip_smoke.py phase c runs this at full width)."""
    state, actions = setup
    ref_state, ref_out = _jnp_replay(state, actions, P)
    sf, si = pack_state(state, P)
    sf2, si2, rew = fused_rollout_replay(sf, si, replay_actions(actions), P)
    got = unpack_state(sf2, si2, jax.random.PRNGKey(0), P)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref_state.pos),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(rew), np.asarray(ref_out.reward),
                               rtol=1e-4, atol=1e-4)
