"""Worker for the 2-process jax.distributed CPU test (not collected by
pytest — invoked as a subprocess by tests/test_multiprocess.py).

Each process brings up the distributed runtime, builds the global 'env'
mesh spanning BOTH processes' fake CPU devices, constructs a globally
sharded RunnerState, and runs one sharded PPO iteration — exercising
parallel.mesh.init_distributed and the cross-process gradient pmean
(the multi-host code path) end to end.

Usage: python tests/_mp_worker.py <coordinator> <num_processes> <pid>
"""

from __future__ import annotations

import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    coordinator, num_processes, pid = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    )
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

    from gym_futbol_tpu.parallel.mesh import init_distributed

    init_distributed(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=pid,
    )
    assert jax.process_count() == num_processes, jax.process_count()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == num_processes * n_local, (n_global, n_local)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.parallel import make_mesh, shard_train_iteration
    from gym_futbol_tpu.parallel.mesh import ENV_AXIS
    from gym_futbol_tpu.ppo import PPOConfig, init_runner, make_optimizer

    env_params = EnvParams(
        players_per_team=1, max_steps=16, substeps=2, solver_iterations=3
    )
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    model = ActorCritic(n_players=env_params.players_per_team, hidden=(16,))
    tx = make_optimizer(cfg)
    mesh = make_mesh()  # global: spans both processes

    # Same seed on every process => identical full local copies; lift them
    # to global arrays by handing each process its addressable shards.
    runner = init_runner(
        jax.random.PRNGKey(0), model, env_params, cfg,
        n_envs=2 * n_global, tx=tx,
    )
    env_sh = NamedSharding(mesh, P(ENV_AXIS))
    rep_sh = NamedSharding(mesh, P())

    def globalize(x, sh):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    runner = runner.replace(
        params=jax.tree.map(lambda x: globalize(x, rep_sh), runner.params),
        opt_state=jax.tree.map(
            lambda x: globalize(x, rep_sh), runner.opt_state
        ),
        env_state=jax.tree.map(
            lambda x: globalize(x, env_sh), runner.env_state
        ),
        obs=globalize(runner.obs, env_sh),
        key=globalize(runner.key, rep_sh),
    )

    step_fn = shard_train_iteration(mesh, model, env_params, cfg, tx)
    runner, metrics = step_fn(runner)
    loss = float(metrics["loss"])            # replicated => readable
    psum = float(
        sum(np.abs(np.asarray(l)).sum()
            for l in jax.tree.leaves(runner.params))
    )
    assert np.isfinite(loss), loss
    print(f"RESULT pid={pid} loss={loss:.10f} params_sum={psum:.10f}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
