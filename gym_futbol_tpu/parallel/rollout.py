"""Sharded rollout and training over the 'env' mesh axis.

Two idiomatic paths are provided (the scaling-book recipe: annotate
shardings, let XLA insert collectives):

- :func:`shard_rollout` — jit + NamedSharding. The env batch is sharded
  over 'env'; the step itself is collective-free, so XLA compiles a pure
  SPMD program with no communication.
- :func:`shard_train_iteration` — ``shard_map`` of the full PPO iteration
  with an explicit ``pmean`` over gradients/metrics (the one collective;
  SURVEY.md §2.3, §3.6). shard_map is used here because the minibatch
  permutation inside the update must be *per-shard* (device-local
  trajectories), which auto-sharding cannot express.

Both run unchanged on 1 GPU, several GPUs of one host, 8 fake CPU
devices, or several hosts (BASELINE configs 4-5).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from .. import vector
from ..ppo import RunnerState, train_iteration
from ..types import EnvParams, EnvState
from .mesh import ENV_AXIS, env_sharding


def shard_env_state(state, mesh: Mesh):
    """Place a batched EnvState (or any env-leading pytree) on the mesh,
    sharded over its leading axis."""
    sh = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def shard_runner(runner, mesh: Mesh, runner_specs=None):
    """Place a whole training runner on the mesh as
    :func:`shard_train_iteration` returns it — env-local leaves over
    'env', the rest replicated — so that the second iteration reuses the
    first one's compiled program. A one-device mesh returns every leaf
    replicated (a size-1 axis splits nothing), so there everything is
    placed replicated."""
    specs = runner_specs if runner_specs is not None else ppo_runner_specs()
    single = mesh.shape[ENV_AXIS] == 1

    def put(spec, sub):
        sh = NamedSharding(mesh, P() if single else spec)
        return jax.tree.map(lambda x: jax.device_put(x, sh), sub)

    return jax.tree.map(put, specs, runner, is_leaf=lambda x: isinstance(x, P))


def shard_rollout(
    mesh: Mesh, params: EnvParams, n_steps: int,
    policy: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
):
    """Compile a sharded T-step rollout. Returns f(state, key) ->
    (state, outs) with the env batch sharded over 'env'."""
    policy = policy or vector.random_policy(params)

    sh_env = env_sharding(mesh)

    @partial(jax.jit, donate_argnums=(0,))
    def run(state: EnvState, key: jax.Array):
        state = jax.lax.with_sharding_constraint(state, sh_env)
        return vector.rollout(state, policy, key, params, n_steps)

    return run


def shard_fused_rollout(
    mesh: Mesh, params: EnvParams, n_steps: int, block: int | None = None,
    interpret: bool = False,
):
    """The fused-rollout kernel (ops/fused_rollout.py) composed with the
    'env' mesh: each device runs the whole-T-steps kernel on its local env
    shard — still zero collectives on the step path.

    Returns f(statef, statei, seed) -> (statef, statei, rewards), jitted,
    where statef/statei are the packed env-last layout (ops.pack_state)
    with the env axis (dim 1) sharded over 'env'. The per-device env
    count must be a multiple of ``block``. Shards share the seed and draw
    from the streams of their GLOBAL env indices, so the result does not
    depend on how the batch is split.
    """
    from ..ops import fused_rollout
    from ..ops.fused_rollout import DEFAULT_BLOCK

    block = block or DEFAULT_BLOCK

    def local(statef, statei, seed):
        offset = jax.lax.axis_index(ENV_AXIS) * statef.shape[1]
        return fused_rollout(
            statef, statei, seed, params, n_steps, block,
            interpret=interpret, env_offset=offset,
        )

    cols = P(None, ENV_AXIS)
    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(cols, cols, P()),
        out_specs=(cols, cols, cols),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1))


def ppo_runner_specs(
    normalize_obs: bool = False, normalize_reward: bool = False,
):
    """PartitionSpec pytree for a ppo.RunnerState: envs/trajectory
    device-local, model/optimizer replicated. The VecNormalize stats
    (when enabled) are replicated — their batch updates are pmean'd over
    the mesh (wrappers.RunningNorm.update), so every shard carries the
    ONE global normalizer — except RewardNorm's per-env return
    accumulator, which lives with its envs."""
    from ..wrappers import RewardNorm, RunningNorm

    env_spec = P(ENV_AXIS)
    rep = P()
    obs_norm = (
        RunningNorm(mean=rep, var=rep, count=rep) if normalize_obs else None
    )
    rew_norm = (
        RewardNorm(ret=env_spec, mean=rep, var=rep, count=rep)
        if normalize_reward else None
    )
    return RunnerState(
        params=rep,
        opt_state=rep,
        env_state=EnvState(
            pos=env_spec, vel=env_spec, possession=env_spec,
            score=env_spec, t=env_spec, key=env_spec,
        ),
        obs=env_spec,
        key=rep,  # same update RNG on every shard => replicated params stay in lockstep
        obs_norm=obs_norm,
        rew_norm=rew_norm,
    )


def _local_iteration(model, env_params, cfg, tx, iteration_fn):
    """The per-shard body of a sharded iteration: decorrelate per-shard
    action sampling / minibatch permutations by folding the shard index
    into the key; params stay in lockstep because grads are pmean'd
    before applying."""

    def local_iter(runner):
        base_key, next_key = jax.random.split(runner.key)
        shard_key = jax.random.fold_in(base_key, jax.lax.axis_index(ENV_AXIS))
        runner, metrics = iteration_fn(
            runner.replace(key=shard_key), model, env_params, cfg, tx,
            axis_name=ENV_AXIS,
        )
        # hand back the replicated successor key so the out_spec P() holds
        return runner.replace(key=next_key), metrics

    return local_iter


def shard_train_iteration(
    mesh: Mesh, model, env_params: EnvParams, cfg, tx,
    iteration_fn=train_iteration, runner_specs=None,
):
    """shard_map'd full training iteration: envs + trajectories
    device-local, model/opt state replicated, grads pmean'd over 'env'.

    ``iteration_fn`` defaults to PPO's; any function with the signature
    ``(runner, model, env_params, cfg, tx, axis_name) -> (runner, metrics)``
    works (e.g. :func:`gym_futbol_tpu.a2c.train_iteration`).
    ``runner_specs`` overrides the PartitionSpec pytree for non-default
    runner structures (e.g. ``a2c.recurrent_runner_specs()`` for the
    LSTM carry). Returns f(runner) -> (runner, metrics), jitted.
    """

    local_iter = _local_iteration(model, env_params, cfg, tx, iteration_fn)
    rep = P()
    if runner_specs is None:
        runner_specs = ppo_runner_specs()

    mapped = shard_map(
        local_iter,
        mesh=mesh,
        in_specs=(runner_specs,),
        out_specs=(runner_specs, rep),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0,))


def emulate_sharded_iteration(
    n_shards: int, model, env_params: EnvParams, cfg, tx,
    iteration_fn=train_iteration, runner_specs=None,
):
    """The one-device reference for :func:`shard_train_iteration` on an
    ``n_shards``-device mesh: the same per-shard body, ``vmap``'d over an
    ``'env'`` axis of size ``n_shards`` on one device, so shard keys,
    per-shard minibatch permutations and the gradient ``pmean`` are those
    of the sharded run; only summation order and matmul algorithms
    differ. Returns f(runner) -> (runner, metrics) over the same global
    runner, jitted."""
    if runner_specs is None:
        runner_specs = ppo_runner_specs()
    local_iter = _local_iteration(model, env_params, cfg, tx, iteration_fn)

    def env_axis(spec):
        return spec.index(ENV_AXIS) if ENV_AXIS in spec else None

    def split(spec, x):
        k = env_axis(spec)
        if k is None:
            return jnp.broadcast_to(x, (n_shards,) + x.shape)
        x = x.reshape(x.shape[:k] + (n_shards, x.shape[k] // n_shards)
                      + x.shape[k + 1:])
        return jnp.moveaxis(x, k, 0)

    def merge(spec, x):
        k = env_axis(spec)
        if k is None:
            return x[0]
        x = jnp.moveaxis(x, 0, k)
        return x.reshape(x.shape[:k] + (-1,) + x.shape[k + 2:])

    def over(fn, runner):
        return jax.tree.map(
            lambda spec, sub: jax.tree.map(partial(fn, spec), sub),
            runner_specs, runner, is_leaf=lambda x: isinstance(x, P),
        )

    @jax.jit
    def run(runner):
        out, metrics = jax.vmap(local_iter, axis_name=ENV_AXIS)(
            over(split, runner)
        )
        return over(merge, out), jax.tree.map(lambda m: m[0], metrics)

    return run
