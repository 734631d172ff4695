"""PPO learner unit tests: GAE vs hand-computed values, loss sanity,
single-device training smoke (SURVEY.md §4.2; sharded path covered in
test_sharding.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from gym_futbol_tpu import EnvParams
from gym_futbol_tpu.models.policy import (
    ActorCritic,
    action_log_prob_and_entropy,
    init_params,
    sample_actions,
)
from gym_futbol_tpu.ppo import (
    PPOConfig,
    Transition,
    _flatten_tm,
    _forward_fm,
    _logp_entropy_rows,
    _obs_to_fm,
    compute_gae,
    init_runner,
    make_optimizer,
    train_iteration,
    update_epochs,
)


ENV_P = EnvParams(players_per_team=1, max_steps=32)


class TestGAE:
    def test_matches_reference_formula(self):
        """Compare against an explicit python-loop GAE."""
        cfg = PPOConfig(gamma=0.9, gae_lambda=0.8)
        T, B = 5, 2
        rng = np.random.RandomState(0)
        rewards = rng.randn(T, B).astype(np.float32)
        values = rng.randn(T, B).astype(np.float32)
        dones = (rng.rand(T, B) < 0.3)
        last_value = rng.randn(B).astype(np.float32)

        traj = Transition(
            obs=jnp.zeros((T, B, 1)), dirs=jnp.zeros((T, B), jnp.int32),
            acts=jnp.zeros((T, B), jnp.int32),
            logp=jnp.zeros((T, B)), value=jnp.asarray(values),
            reward=jnp.asarray(rewards), done=jnp.asarray(dones),
        )
        adv, ret = compute_gae(traj, jnp.asarray(last_value), cfg)

        expected = np.zeros((T, B), np.float32)
        gae = np.zeros(B, np.float32)
        next_v = last_value
        for t in reversed(range(T)):
            nonterm = 1.0 - dones[t]
            delta = rewards[t] + cfg.gamma * next_v * nonterm - values[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterm * gae
            expected[t] = gae
            next_v = values[t]
        np.testing.assert_allclose(np.asarray(adv), expected, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(ret), expected + values, rtol=1e-5
        )


class TestPolicy:
    def test_sample_and_logprob_consistent(self, key):
        model = ActorCritic(n_players=2, hidden=(16,))
        params = init_params(key, model, ENV_P)
        obs = jax.random.normal(key, (7, 4 * ENV_P.n_bodies + 2))
        logits, value = model.apply(params, obs)
        assert logits.shape == (7, 2 * 2 * 5)  # flat: [B, n_players*2*5]
        assert value.shape == (7,)
        actions, logp = sample_actions(key, logits)
        assert actions.shape == (7, 2, 2)
        logp2, ent = action_log_prob_and_entropy(logits, actions)
        np.testing.assert_allclose(
            np.asarray(logp), np.asarray(logp2), rtol=1e-5, atol=1e-6
        )
        assert (np.asarray(ent) > 0).all()
        assert (np.asarray(actions) >= 0).all() and (np.asarray(actions) < 5).all()

    def test_sampling_matches_softmax_distribution(self, key):
        """Inverse-CDF sampling reproduces the softmax probabilities."""
        one = [2.0, 0.0, -1.0, 0.5, 1.0]
        logits = jnp.asarray([one + one])  # one player: dir + act groups
        probs = np.asarray(jax.nn.softmax(jnp.asarray(one)))
        n = 20000
        keys = jax.random.split(key, n)
        acts = jax.vmap(lambda k: sample_actions(k, logits)[0])(keys)
        counts = np.bincount(np.asarray(acts).reshape(-1), minlength=5) / (2 * n)
        np.testing.assert_allclose(counts, probs, atol=0.02)


class TestFeatureMajorUpdate:
    """The PPO update consumes the buffer feature-major ([F, N]); these
    certify that path against the row-major ``model.apply`` forward."""

    def test_feature_major_forward_matches_apply(self, key):
        model = ActorCritic(n_players=2, hidden=(16, 8))
        params = init_params(key, model, ENV_P)
        obs = jax.random.normal(key, (37, 4 * ENV_P.n_bodies + 2))
        logits, value = model.apply(params, obs)
        fm_logits, fm_value = _forward_fm(params, model, obs.T)
        np.testing.assert_allclose(
            np.asarray(fm_logits), np.asarray(logits).T, rtol=2e-5,
            atol=2e-6,
        )
        np.testing.assert_allclose(
            np.asarray(fm_value), np.asarray(value), rtol=2e-5, atol=2e-6
        )

    def test_logp_entropy_rows_matches_packed(self, key):
        from gym_futbol_tpu.models.policy import (
            action_log_prob_and_entropy_packed,
        )

        g5 = 2 * 2 * 5
        logits = jax.random.normal(key, (13, g5))
        dirs = jax.random.randint(key, (13,), 0, 2**6, dtype=jnp.int32)
        acts = jax.random.randint(jax.random.fold_in(key, 1), (13,), 0,
                                  2**6, dtype=jnp.int32)
        logp, ent = action_log_prob_and_entropy_packed(logits, dirs, acts)
        logp2, ent2 = _logp_entropy_rows(logits.T, dirs, acts)
        np.testing.assert_allclose(np.asarray(logp2), np.asarray(logp),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ent2), np.asarray(ent),
                                   rtol=1e-6, atol=1e-6)

    def test_flatten_tm_matches_obs_to_fm_order(self):
        """_obs_to_fm's column order and _flatten_tm's sample order must
        agree — the update pairs obs columns with flattened fields."""
        t, b2, f = 3, 8, 4
        code = (
            100.0 * jnp.arange(t, dtype=jnp.float32)[:, None]
            + jnp.arange(b2, dtype=jnp.float32)[None, :]
        )  # [T, 2B] unique per (t, row)
        obs3 = jnp.broadcast_to(code[:, :, None], (t, b2, f))
        np.testing.assert_array_equal(
            np.asarray(_obs_to_fm(obs3)[0]), np.asarray(_flatten_tm(code))
        )

    def test_update_layout_equivalence(self, key):
        """update_epochs(rank-3 row-major obs) == update_epochs(rank-2
        feature-major obs) — same permutations, same math."""
        cfg = PPOConfig(rollout_steps=4, epochs=2, minibatches=2,
                        shuffle_block=1)
        model = ActorCritic(n_players=1, hidden=(16,))
        params = init_params(key, model, ENV_P)
        tx = make_optimizer(cfg)
        opt_state = tx.init(params)
        t, b2, f = 4, 6, 4 * ENV_P.n_bodies + 2
        ks = jax.random.split(key, 8)
        traj = Transition(
            obs=jax.random.normal(ks[0], (t, b2, f)),
            dirs=jax.random.randint(ks[1], (t, b2), 0, 5, dtype=jnp.int32),
            acts=jax.random.randint(ks[2], (t, b2), 0, 5, dtype=jnp.int32),
            logp=-jnp.abs(jax.random.normal(ks[3], (t, b2))),
            value=jax.random.normal(ks[4], (t, b2)),
            reward=jax.random.normal(ks[5], (t, b2)),
            done=jnp.zeros((t, b2), bool),
        )
        adv, ret = compute_gae(traj, jnp.zeros(b2), cfg)
        p1, _, m1 = update_epochs(
            params, opt_state, traj, adv, ret, ks[6], model, tx, cfg
        )
        traj_fm = traj.replace(obs=_obs_to_fm(traj.obs))
        p2, _, m2 = update_epochs(
            params, opt_state, traj_fm, adv, ret, ks[6], model, tx, cfg
        )
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-6)

    def test_remat_matches_no_remat(self, key):
        cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=1,
                        shuffle_block=1)
        cfg_nr = PPOConfig(rollout_steps=4, epochs=1, minibatches=1,
                           shuffle_block=1, remat=False)
        model = ActorCritic(n_players=1, hidden=(16,))
        params = init_params(key, model, ENV_P)
        tx = make_optimizer(cfg)
        opt_state = tx.init(params)
        t, b2, f = 4, 4, 4 * ENV_P.n_bodies + 2
        ks = jax.random.split(key, 8)
        traj = Transition(
            obs=jax.random.normal(ks[0], (t, b2, f)),
            dirs=jax.random.randint(ks[1], (t, b2), 0, 5, dtype=jnp.int32),
            acts=jax.random.randint(ks[2], (t, b2), 0, 5, dtype=jnp.int32),
            logp=-jnp.abs(jax.random.normal(ks[3], (t, b2))),
            value=jax.random.normal(ks[4], (t, b2)),
            reward=jax.random.normal(ks[5], (t, b2)),
            done=jnp.zeros((t, b2), bool),
        )
        adv, ret = compute_gae(traj, jnp.zeros(b2), cfg)
        p1, _, _ = update_epochs(
            params, opt_state, traj, adv, ret, ks[6], model, tx, cfg
        )
        p2, _, _ = update_epochs(
            params, opt_state, traj, adv, ret, ks[6], model, tx, cfg_nr
        )
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


class TestTraining:
    def test_small_buffer_minibatches_not_empty(self, key):
        """Regression (ADVICE r1): when T*B is a multiple of shuffle_block
        but has fewer blocks than minibatches, the shuffle must fall back
        to row granularity instead of producing empty minibatches."""
        cfg = PPOConfig(rollout_steps=8, epochs=1, minibatches=4,
                        shuffle_block=128)
        n = 8 * 2 * 16  # rollout_steps * both views * envs
        assert n % cfg.shuffle_block == 0
        assert n // cfg.shuffle_block < cfg.minibatches
        model = ActorCritic(n_players=ENV_P.players_per_team, hidden=(16,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, ENV_P, cfg, n_envs=16, tx=tx)
        runner, metrics = jax.jit(
            lambda r: train_iteration(r, model, ENV_P, cfg, tx)
        )(runner)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), (k, float(v))

    def test_single_device_iteration(self, key):
        cfg = PPOConfig(rollout_steps=8, epochs=2, minibatches=2)
        model = ActorCritic(n_players=ENV_P.players_per_team, hidden=(32,))
        tx = make_optimizer(cfg)
        runner = init_runner(key, model, ENV_P, cfg, n_envs=8, tx=tx)
        f = jax.jit(
            lambda r: train_iteration(r, model, ENV_P, cfg, tx)
        )
        runner, metrics = f(runner)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k
        runner2, metrics2 = f(runner)
        p0 = jax.tree.leaves(runner.params)[0]
        p2 = jax.tree.leaves(runner2.params)[0]
        assert not np.allclose(np.asarray(p0), np.asarray(p2))


class TestObsNormFolding:
    """RunningNorm's moment merge: folding pre-computed batch moments in
    (update_moments) equals folding the batch itself (update)."""

    def test_update_moments_matches_update(self, key):
        from gym_futbol_tpu.wrappers import RunningNorm

        obs = jax.random.normal(key, (64, 10)) * 2.0 + 3.0
        n0 = RunningNorm.init(10)
        a = n0.update(obs)
        b = n0.update_moments(obs.mean(axis=0), obs.var(axis=0),
                              jnp.asarray(64.0))
        np.testing.assert_allclose(np.asarray(a.mean), np.asarray(b.mean),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(a.var), np.asarray(b.var),
                                   rtol=1e-6)


class TestShuffleBlockFallback:
    def test_degrades_to_largest_divisor(self):
        """ADVICE r3 item 2: a buffer divisible by 128 but not by
        shuffle_block must degrade to a chunky divisor, not to block=1."""
        from gym_futbol_tpu.ppo import _shuffle_block_for

        cfg = PPOConfig(shuffle_block=1024, minibatches=4)
        assert _shuffle_block_for(8192, cfg) == 1024
        # 3 * 1024 samples, 4 minibatches -> <=768 per block; 768 divides
        assert _shuffle_block_for(3072, cfg) == 768
        # divisible by 128, not 1024 -> 128-aligned divisor, never 1
        got = _shuffle_block_for(128 * 5, cfg)
        assert got > 1 and (128 * 5) % got == 0
        # tiny pathological buffer still yields valid minibatches
        assert _shuffle_block_for(7, cfg) == 1

    def test_update_epochs_on_odd_buffer(self, key):
        """update_epochs stays correct (non-empty minibatches, finite
        loss) on a buffer that triggers the degraded block size."""
        from gym_futbol_tpu.models.policy import init_params

        p = EnvParams(players_per_team=1)
        cfg = PPOConfig(rollout_steps=3, epochs=1, minibatches=2,
                        shuffle_block=1024, remat=False)
        model = ActorCritic(n_players=1, hidden=(8,))
        params = init_params(key, model, p)
        tx = make_optimizer(cfg)
        t, b2 = 3, 2 * 128   # n = 768: not divisible by 1024
        f = 4 * p.n_bodies + 2
        ks = jax.random.split(key, 6)
        traj = Transition(
            obs=jax.random.normal(ks[0], (t, b2, f)),
            dirs=jax.random.randint(ks[1], (t, b2), 0, 5, jnp.int32),
            acts=jax.random.randint(ks[2], (t, b2), 0, 5, jnp.int32),
            logp=-jnp.abs(jax.random.normal(ks[3], (t, b2))),
            value=jax.random.normal(ks[4], (t, b2)),
            reward=jax.random.normal(ks[5], (t, b2)),
            done=jnp.zeros((t, b2), bool),
        )
        adv, ret = compute_gae(traj, jnp.zeros(b2), cfg)
        p2, _, m = update_epochs(
            params, tx.init(params), traj, adv, ret, key, model, tx, cfg
        )
        assert np.isfinite(float(m["loss"]))
        assert any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2))
        )
