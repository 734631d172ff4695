"""PPO learner, fully on-device (BASELINE.json configs 4-5).

The reference's training story is stable-baselines ``PPO2`` over a Python
rollout loop (SURVEY.md §3.5) — host-bound, single process, one agent
controlling one side. Here the whole iteration (rollout with lax.scan ->
GAE -> minibatched clipped-surrogate epochs) is one jittable pure function
over the batched env, so it runs as a single XLA program per iteration and
shards over the ``env`` mesh axis (see :mod:`gym_futbol_tpu.parallel`):
trajectories stay device-local, the only collective is the gradient/metric
reduction (SURVEY.md §2.3).

TRAINING SETUP: symmetric SELF-PLAY with one shared per-team policy. The
env is two-sided; the learner controls team 0 directly and team 1 through
the mirrored observation (env.mirror_obs / env.mirror_actions), and BOTH
perspectives' transitions — each with its own team's reward — fill the
buffer (2x samples per env-step at one env's cost). This matches the
reference's one-agent-one-side semantics (SURVEY.md §3.5) while staying
fully batched; a single joint policy rewarded only on team 0 would learn
to make team 1 concede.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from . import pytree
from . import env as env_core
from .models.policy import (
    ActorCritic,
    pack_actions,
    sample_actions,
)
from .types import EnvParams, EnvState
from .vector import step_batch


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    # Final LR for the linear anneal; only active when make_optimizer is
    # given total_iters (else constant cfg.lr). None (the default) anneals
    # to a 0.1*lr FLOOR rather than 0: the r4 curves showed a linear->0
    # schedule spends the last ~5-10% of every training budget doing no-op
    # updates (pg_loss/approx_kl == 0 at the tail — VERDICT r4 weak #3);
    # a floor keeps late iterations learning. Pass 0.0 explicitly to
    # recover the anneal-to-zero schedule.
    lr_final: float | None = None
    epochs: int = 4
    minibatches: int = 4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    # Minibatch shuffling granularity. Shuffling contiguous blocks of
    # samples gathers whole chunks instead of single rows out of a
    # multi-GB buffer. A block of consecutive flat indices is
    # `shuffle_block` *independent* envs from one (view, timestep), so
    # minibatch statistics are unaffected. In the feature-major buffer a
    # block's obs is F strided runs of 4*shuffle_block bytes — 1024 keeps
    # every gathered run at 4 KB. Set to 1 for row-level shuffling.
    shuffle_block: int = 1024
    # Rematerialize the policy forward inside the update's backward pass
    # (jax.checkpoint around the per-sample loss core): recomputing the
    # [mb, hidden] activations costs ~1/3 more matmul flops and removes
    # almost all activation traffic to device memory.
    remat: bool = True


@pytree.dataclass
class Transition:
    """One step of experience. Actions are stored BIT-PACKED (3 bits per
    player, one int32 word per action slot) so every leaf of the stacked
    [T, B, ...] trajectory is at most rank-3 with a wide minor dim — a
    [T, B, n_players, 2] int32 buffer puts (n_players, 2) on the tiled
    minor dims and pads ~100x (see models/policy.py docstring).

    STACKED-TRAJECTORY OBS LAYOUTS (update_epochs accepts both, keyed on
    rank): rank-3 ``[T, B, obs_dim]`` row-major (what the collect emits,
    also consumed whole-batch by a2c), or rank-2 ``[obs_dim, T*B]``
    FEATURE-MAJOR with samples ordered (view, step, env), the layout the
    update's forward contracts over."""

    obs: jax.Array        # [B, obs_dim] per step; stacked: see above
    dirs: jax.Array       # [B] int32, packed per-player direction indices
    acts: jax.Array       # [B] int32, packed per-player act indices
    logp: jax.Array       # [B]
    value: jax.Array      # [B]
    reward: jax.Array     # [B]
    done: jax.Array       # [B]


@pytree.dataclass
class RunnerState:
    params: Any
    opt_state: Any
    env_state: EnvState   # batched
    obs: jax.Array        # [B, obs_dim] RAW (un-normalized) observation
    key: jax.Array
    # VecNormalize-equivalent running stats (wrappers.py), carried across
    # iterations when training with --normalize-obs / --normalize-reward
    # (make_normalized_collect). None = off (and an empty pytree node, so
    # specs/checkpoints of un-normalized runners are unchanged).
    obs_norm: Any = None   # wrappers.RunningNorm | None
    rew_norm: Any = None   # wrappers.RewardNorm | None


def make_optimizer(
    cfg: PPOConfig, total_iters: int | None = None
) -> optax.GradientTransformation:
    """Adam with global-norm clipping. When ``total_iters`` is given the
    learning rate anneals linearly from cfg.lr to cfg.lr_final over the
    run's total number of minibatch updates (the usual PPO schedule;
    measurably steadies late training in parity/check_learning.py).
    cfg.lr_final=None (default) means a 0.1*lr floor — see PPOConfig."""
    lr = cfg.lr
    if total_iters:
        lr_final = 0.1 * cfg.lr if cfg.lr_final is None else cfg.lr_final
        lr = optax.linear_schedule(
            cfg.lr, lr_final,
            total_iters * cfg.epochs * cfg.minibatches,
        )
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(lr),
    )


def _both_views(obs: jax.Array, env_params: EnvParams) -> jax.Array:
    """[B, F] world obs -> [2B, F]: rows [:B] are the team-0 view, rows
    [B:] the team-1 view (env.mirror_obs)."""
    return jnp.concatenate([obs, env_core.mirror_obs(obs, env_params)], axis=0)


def collect_rollout(
    runner: RunnerState, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig,
) -> tuple[RunnerState, Transition, jax.Array]:
    """T steps of SELF-PLAY experience via lax.scan.

    ``model`` is a per-TEAM policy (``model.n_players ==
    env_params.players_per_team``). Each step it is applied to the true
    observation (team-0 view) and to the mirrored observation (team-1
    view, :func:`env.mirror_obs`); the two action sets drive BOTH teams
    of the same envs, and BOTH perspectives' transitions enter the buffer
    — team k's rows carry team k's own reward (``out.team_reward[:, k]``),
    so the shared policy improves each side from its own signal instead of
    teaching team 1 to concede. Returns (runner, traj [T, 2B, ...],
    bootstrap value [2B]); rows [:B] are team 0's perspective, rows [B:]
    team 1's in its mirrored frame (actions/logp consistent with the
    mirrored logits).
    """
    assert model.n_players == env_params.players_per_team, (
        f"self-play PPO trains a per-team policy: model.n_players="
        f"{model.n_players} must equal players_per_team="
        f"{env_params.players_per_team}"
    )
    b = runner.obs.shape[0]

    def body(carry, _):
        env_state, obs, key = carry
        key, k_act = jax.random.split(key)
        obs2 = _both_views(obs, env_params)
        logits, value = model.apply(runner.params, obs2)
        action2, logp = sample_actions(k_act, logits)   # [2B, ppt, 2]
        joint = jnp.concatenate(
            [action2[:b], env_core.mirror_actions(action2[b:])], axis=1
        )
        env_state, out = step_batch(env_state, joint, env_params)
        dirs, acts = pack_actions(action2)
        tr = Transition(
            obs=obs2, dirs=dirs, acts=acts, logp=logp, value=value,
            reward=jnp.concatenate(
                [out.team_reward[:, 0], out.team_reward[:, 1]], axis=0
            ),
            done=jnp.concatenate([out.done, out.done], axis=0),
        )
        return (env_state, out.obs, key), tr

    (env_state, obs, key), traj = jax.lax.scan(
        body, (runner.env_state, runner.obs, runner.key), None,
        length=cfg.rollout_steps,
    )
    _, last_value = model.apply(runner.params, _both_views(obs, env_params))
    runner = runner.replace(env_state=env_state, obs=obs, key=key)
    return runner, traj, last_value


def make_normalized_collect(
    normalize_obs: bool = True, normalize_reward: bool = True,
    axis_name: str | None = None,
):
    """Collect-fn factory with VecNormalize semantics (SURVEY.md §2.1 #12
    ecosystem; VERDICT r2 item 4): observation z-scoring and/or
    reward-by-return-std scaling THROUGH WHICH the policy actually trains.

    Statistics live in ``runner.obs_norm`` / ``runner.rew_norm``
    (wrappers.RunningNorm/RewardNorm) and are updated inside the rollout
    scan; with ``axis_name`` set (the sharded path) the batch statistics
    are pmean'd so every shard applies ONE global normalizer. Mirroring
    happens on the RAW observation (mirror_obs's x -> 1-x algebra assumes
    field-normalized coordinates, not z-scores); both self-play views are
    then normalized with the same stats — they are identically
    distributed by symmetry. The trajectory stores NORMALIZED obs (what
    the policy saw) and scaled rewards, so the update needs no changes.
    Returns a drop-in for :func:`collect_rollout` (jnp path).
    """

    def collect(
        runner: RunnerState, model: ActorCritic, env_params: EnvParams,
        cfg: PPOConfig,
    ) -> tuple[RunnerState, Transition, jax.Array]:
        assert (not normalize_obs) or runner.obs_norm is not None, (
            "init_runner(..., normalize_obs=True) required"
        )
        assert (not normalize_reward) or runner.rew_norm is not None, (
            "init_runner(..., normalize_reward=True) required"
        )
        b = runner.obs.shape[0]

        def norm_obs2(onorm, obs_raw, update: bool):
            obs2_raw = _both_views(obs_raw, env_params)
            if not normalize_obs:
                return onorm, obs2_raw
            if update:
                onorm = onorm.update(obs2_raw, axis_name=axis_name)
            return onorm, onorm.normalize(obs2_raw)

        def body(carry, _):
            env_state, obs, onorm, rnorm, key = carry
            key, k_act = jax.random.split(key)
            onorm, obs2 = norm_obs2(onorm, obs, update=True)
            logits, value = model.apply(runner.params, obs2)
            action2, logp = sample_actions(k_act, logits)
            joint = jnp.concatenate(
                [action2[:b], env_core.mirror_actions(action2[b:])], axis=1
            )
            env_state, out = step_batch(env_state, joint, env_params)
            r0, r1 = out.team_reward[:, 0], out.team_reward[:, 1]
            if normalize_reward:
                rnorm = rnorm.update(r0, out.done, cfg.gamma,
                                     axis_name=axis_name)
                r0, r1 = rnorm.normalize(r0), rnorm.normalize(r1)
            dirs, acts = pack_actions(action2)
            tr = Transition(
                obs=obs2, dirs=dirs, acts=acts, logp=logp, value=value,
                reward=jnp.concatenate([r0, r1], axis=0),
                done=jnp.concatenate([out.done, out.done], axis=0),
            )
            return (env_state, out.obs, onorm, rnorm, key), tr

        (env_state, obs, onorm, rnorm, key), traj = jax.lax.scan(
            body,
            (runner.env_state, runner.obs, runner.obs_norm,
             runner.rew_norm, runner.key),
            None, length=cfg.rollout_steps,
        )
        # bootstrap value on FROZEN (post-rollout) stats, no update
        _, obs2 = norm_obs2(onorm, obs, update=False)
        _, last_value = model.apply(runner.params, obs2)
        runner = runner.replace(
            env_state=env_state, obs=obs, key=key, obs_norm=onorm,
            rew_norm=rnorm,
        )
        return runner, traj, last_value

    return collect


def compute_gae(
    traj: Transition, last_value: jax.Array, cfg: PPOConfig
) -> tuple[jax.Array, jax.Array]:
    """Generalized advantage estimation (reverse scan). Returns
    (advantages [T,B], returns [T,B]). Scans only the [T, B] fields it
    needs — traj.obs may be the feature-major [F, N] matrix whose
    leading axis differs from T."""
    gamma = cfg.gamma
    lam = cfg.gae_lambda

    def body(carry, vrd):
        value, reward, done = vrd
        gae, next_value = carry
        nonterminal = 1.0 - done.astype(value.dtype)
        delta = reward + gamma * next_value * nonterminal - value
        gae = delta + gamma * lam * nonterminal * gae
        return (gae, value), gae

    (_, _), adv = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value),
        (traj.value, traj.reward, traj.done), reverse=True,
    )
    return adv, adv + traj.value


def _forward_fm(params, model: ActorCritic, obs_fm: jax.Array):
    """ActorCritic forward on a FEATURE-MAJOR [F, S] obs matrix.

    Same weights/math as ``model.apply`` (certified by
    tests/test_ppo.py::test_feature_major_forward_matches_apply), but
    every Dense is a ``dot_general`` contracting the feature axis with
    samples staying on the minor axis, so the update never transposes
    the [F, N] buffer. Returns (logit rows [G*5, S], value [S])."""
    dense = params["params"]
    x = obs_fm.astype(model.dtype)
    n_hidden = len(model.hidden)
    contract = (((0,), (0,)), ((), ()))
    for i in range(n_hidden):
        layer = dense[f"Dense_{i}"]
        x = jnp.tanh(
            jax.lax.dot_general(layer["kernel"], x, contract)
            + layer["bias"][:, None]
        )
    head_l = dense[f"Dense_{n_hidden}"]
    head_v = dense[f"Dense_{n_hidden + 1}"]
    logits = (
        jax.lax.dot_general(head_l["kernel"], x, contract)
        + head_l["bias"][:, None]
    )
    value = (
        jax.lax.dot_general(head_v["kernel"], x, contract)
        + head_v["bias"][:, None]
    )[0]
    return logits, value


def _logp_entropy_rows(
    logit_rows: jax.Array, dirs_packed: jax.Array, acts_packed: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Row-form joint log-prob + entropy from [G*5, S] logit rows (the
    feature-major twin of models.policy.action_log_prob_and_entropy_packed
    — same math, but the logits are already rows so there is no
    moveaxis)."""
    from .models.policy import N_CHOICES, _log_softmax_rows

    g5 = logit_rows.shape[0]
    assert g5 % N_CHOICES == 0
    logp_total, ent_total = None, None
    for g in range(g5 // N_CHOICES):
        rows = [logit_rows[g * N_CHOICES + i] for i in range(N_CHOICES)]
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


def _loss_core(params, model: ActorCritic, obs_fm, dirs, acts):
    """The per-sample recomputable core of the PPO loss: forward + taken
    log-prob + entropy + value. Wrapped in jax.checkpoint when
    ``cfg.remat`` so its [hidden, S] activations are recomputed in the
    backward pass instead of round-tripping through device memory."""
    logit_rows, value = _forward_fm(params, model, obs_fm)
    logp, entropy = _logp_entropy_rows(logit_rows, dirs, acts)
    return logp, entropy, value


def ppo_loss(
    params, model: ActorCritic, obs_fm: jax.Array, dirs: jax.Array,
    acts: jax.Array, logp_old: jax.Array, value_old: jax.Array,
    adv: jax.Array, returns: jax.Array, cfg: PPOConfig,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Clipped-surrogate PPO loss over one FEATURE-MAJOR minibatch:
    ``obs_fm`` is [F, S]; every other array is [S]."""
    if cfg.remat:
        core = jax.checkpoint(
            lambda p, o, d, a: _loss_core(p, model, o, d, a)
        )
        logp, entropy, value = core(params, obs_fm, dirs, acts)
    else:
        logp, entropy, value = _loss_core(params, model, obs_fm, dirs, acts)
    ratio = jnp.exp(logp - logp_old)

    norm_adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * norm_adv
    pg2 = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * norm_adv
    pg_loss = -jnp.minimum(pg1, pg2).mean()

    v_clipped = value_old + jnp.clip(
        value - value_old, -cfg.clip_eps, cfg.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - returns) ** 2, (v_clipped - returns) ** 2
    ).mean()
    ent = entropy.mean()

    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    metrics = {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "approx_kl": ((ratio - 1) - jnp.log(ratio)).mean(),
    }
    return total, metrics


def _flatten_tm(x: jax.Array) -> jax.Array:
    """[T, 2B] time-major self-play field -> [N] flat samples ordered
    (view, step, env) — the feature-major obs column order of
    :func:`_obs_to_fm`. Moves contiguous [B] rows."""
    t, b2 = x.shape
    return jnp.moveaxis(x.reshape(t, 2, b2 // 2), 1, 0).reshape(t * b2)


def _obs_to_fm(obs3: jax.Array) -> jax.Array:
    """Row-major stacked obs [T, 2B, F] (jnp collect path) -> the
    feature-major [F, N] matrix in _flatten_tm's sample order."""
    t, b2, f = obs3.shape
    return jnp.transpose(
        obs3.reshape(t, 2, b2 // 2, f), (3, 1, 0, 2)
    ).reshape(f, t * b2)


def _shuffle_block_for(n: int, cfg: PPOConfig) -> int:
    """Largest divisor of ``n`` that is <= cfg.shuffle_block and leaves at
    least cfg.minibatches blocks. Degrading granularity (1024 -> 512 ->
    ... -> 128) keeps the gather chunky; only a pathological buffer size
    ever reaches the row-level (block=1) shuffle. ``n`` is static at
    trace time."""
    b = min(cfg.shuffle_block, n // max(cfg.minibatches, 1))
    while b > 1 and n % b:
        b -= 1
    return max(b, 1)


def update_epochs(
    params, opt_state, traj: Transition, adv, returns,
    key: jax.Array, model: ActorCritic, tx, cfg: PPOConfig,
    axis_name: str | None = None,
):
    """cfg.epochs x cfg.minibatches SGD steps over the flattened buffer.

    The buffer is consumed FEATURE-MAJOR: ``traj.obs`` is kept (or
    converted once, if the collect path produced row-major rank-3 obs) as
    an [F, N] matrix so the minibatch forward/backward matmuls contract
    the feature axis with samples on the minor axis.

    When ``axis_name`` is set (shard_map path), gradients and metrics are
    pmean'd across that mesh axis — the one collective on the training
    path (SURVEY.md §2.3).
    """
    t, b2 = traj.reward.shape
    n = t * b2
    obs_fm = traj.obs if traj.obs.ndim == 2 else _obs_to_fm(traj.obs)
    assert obs_fm.shape[1] == n, (
        f"feature-major obs has {obs_fm.shape[1]} samples, buffer has {n}"
    )
    flat_fields = {
        "dirs": traj.dirs, "acts": traj.acts, "logp": traj.logp,
        "value": traj.value, "adv": adv, "ret": returns,
    }
    flat_fields = {k: _flatten_tm(v) for k, v in flat_fields.items()}
    # Block-granular shuffle (see PPOConfig.shuffle_block): reshape the
    # flat sample axis to [n_blocks, block] so the per-epoch permutation
    # gathers whole contiguous chunks instead of single samples. When the
    # buffer size doesn't divide by cfg.shuffle_block (or would leave
    # fewer than `minibatches` blocks — empty minibatches, NaN loss), the
    # granularity DEGRADES to the largest dividing block instead of
    # collapsing to the pathological row-level gather.
    block = _shuffle_block_for(n, cfg)
    n_blocks = n // block
    f_dim = obs_fm.shape[0]
    obs_blk = obs_fm.reshape(f_dim, n_blocks, block)
    flat = {k: v.reshape(n_blocks, block) for k, v in flat_fields.items()}
    mb_blocks = n_blocks // cfg.minibatches
    mb_size = mb_blocks * block

    def epoch(carry, k):
        params, opt_state = carry
        perm = jax.random.permutation(k, n_blocks)

        def minibatch(carry, idx):
            params, opt_state = carry
            take = lambda x: jnp.take(x, idx, axis=0).reshape(mb_size)
            f = {k: take(v) for k, v in flat.items()}
            mb_obs = jnp.take(obs_blk, idx, axis=1).reshape(f_dim, mb_size)
            grads, metrics = jax.grad(ppo_loss, has_aux=True)(
                params, model, mb_obs, f["dirs"], f["acts"], f["logp"],
                f["value"], f["adv"], f["ret"], cfg
            )
            if axis_name is not None:
                grads = jax.lax.pmean(grads, axis_name)
                metrics = jax.lax.pmean(metrics, axis_name)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), metrics

        idxs = perm[: cfg.minibatches * mb_blocks].reshape(
            cfg.minibatches, mb_blocks
        )
        (params, opt_state), metrics = jax.lax.scan(
            minibatch, (params, opt_state), idxs
        )
        return (params, opt_state), metrics

    keys = jax.random.split(key, cfg.epochs)
    (params, opt_state), metrics = jax.lax.scan(
        epoch, (params, opt_state), keys
    )
    return params, opt_state, jax.tree.map(lambda m: m.mean(), metrics)


def train_iteration(
    runner: RunnerState, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig, tx, axis_name: str | None = None,
    collect_fn=None,
) -> tuple[RunnerState, dict[str, jax.Array]]:
    """One full PPO iteration: rollout -> GAE -> epochs of updates.

    Pure and jittable; this is the unit that gets jit'd/shard_map'd by
    :mod:`gym_futbol_tpu.parallel` and by ``train.py``. ``collect_fn``
    defaults to :func:`collect_rollout`; :func:`make_normalized_collect`
    builds the VecNormalize variant.
    """
    collect_fn = collect_fn or collect_rollout
    runner, traj, last_value = collect_fn(runner, model, env_params, cfg)
    adv, returns = compute_gae(traj, last_value, cfg)
    key, k_update = jax.random.split(runner.key)
    params, opt_state, metrics = update_epochs(
        runner.params, runner.opt_state, traj, adv, returns, k_update,
        model, tx, cfg, axis_name,
    )
    # traj rows [:B] are team 0's perspective, [B:] team 1's; report the
    # team-0 view so the metric is comparable with evaluate().
    metrics["mean_reward"] = traj.reward[
        :, : traj.reward.shape[1] // 2
    ].mean()
    if axis_name is not None:
        metrics["mean_reward"] = jax.lax.pmean(metrics["mean_reward"], axis_name)
    runner = runner.replace(params=params, opt_state=opt_state, key=key)
    return runner, metrics


def init_runner(
    key: jax.Array, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig, n_envs: int, tx,
    normalize_obs: bool = False, normalize_reward: bool = False,
) -> RunnerState:
    from .vector import reset_batch

    k_params, k_env, k_run = jax.random.split(key, 3)
    dummy = jnp.zeros((1, env_core.obs_size(env_params)), model.dtype)
    params = model.init(k_params, dummy)
    opt_state = tx.init(params)
    env_state, obs = reset_batch(k_env, env_params, n_envs)
    obs_norm = rew_norm = None
    if normalize_obs:
        from .wrappers import RunningNorm

        obs_norm = RunningNorm.init(env_core.obs_size(env_params))
    if normalize_reward:
        from .wrappers import RewardNorm

        rew_norm = RewardNorm.init(n_envs)
    return RunnerState(
        params=params, opt_state=opt_state, env_state=env_state, obs=obs,
        key=k_run, obs_norm=obs_norm, rew_norm=rew_norm,
    )
