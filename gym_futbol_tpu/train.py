"""Training CLI: sharded PPO on FutbolEnv (BASELINE configs 4-5 shape).

The reference's training entry is a script calling stable-baselines
``PPO2(...).learn()`` over a Python rollout loop (SURVEY.md §3.5). Ours
runs the whole iteration on-device, envs sharded over the 'env' mesh:

    python -m gym_futbol_tpu.train --ppt 3 --envs 16384 --iters 100

Multi-host: launch one process per host with the usual JAX env vars; the
mesh spans all processes' devices (gym_futbol_tpu.parallel.mesh).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv: list[str] | None = None) -> None:
    """Parse ``argv`` (default: ``sys.argv[1:]``) and train."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("ppo", "a2c"), default="ppo")
    ap.add_argument("--recurrent", action="store_true",
                    help="train the LSTM actor-critic (MlpLstmPolicy "
                         "analog): --algo a2c => full-batch BPTT A2C; "
                         "--algo ppo => sequence-minibatched clipped-"
                         "surrogate recurrent PPO (recurrent_ppo.py)")
    ap.add_argument("--lstm-size", type=int, default=128)
    ap.add_argument("--normalize-obs", action="store_true",
                    help="VecNormalize-style observation z-scoring "
                         "through which the policy trains (one GLOBAL "
                         "normalizer across shards; feedforward PPO only)")
    ap.add_argument("--normalize-reward", action="store_true",
                    help="VecNormalize-style reward scaling by the "
                         "running std of discounted returns (feedforward "
                         "PPO only)")
    ap.add_argument("--ppt", type=int, default=2, help="players per team")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout-steps", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-anneal", action="store_true",
                    help="linearly anneal the learning rate from --lr to "
                         "--lr-final over the run's --iters (the schedule "
                         "parity/check_learning.py trains with; PPO only)")
    ap.add_argument("--lr-final", type=float, default=None,
                    help="anneal target; default (unset) is the 0.1*lr "
                         "floor — a linear->0 schedule spends its last "
                         "~5-10%% of iterations doing no-op updates "
                         "(VERDICT r4); pass 0.0 for the old schedule")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--hidden", type=int, nargs="+", default=[256, 256])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=300)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--log-dir", type=str, default=None,
                    help="write metrics.jsonl (+ TensorBoard if available)")
    ap.add_argument("--distributed", action="store_true",
                    help="call jax.distributed.initialize() (multi-host)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="enable jax_debug_nans: fail fast with a "
                         "traceback at the first NaN-producing op "
                         "(disables some fusions; debugging only)")
    args = ap.parse_args(argv)

    import jax

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from .models.policy import ActorCritic
    from .parallel import make_mesh, shard_runner, shard_train_iteration
    from .parallel.mesh import init_distributed
    from .ppo import PPOConfig, init_runner, make_optimizer
    from .types import EnvParams

    if args.distributed:
        init_distributed(force=True)

    env_params = EnvParams(players_per_team=args.ppt, max_steps=args.max_steps)
    runner_specs = None
    normalizing = args.normalize_obs or args.normalize_reward
    if normalizing and (args.algo != "ppo" or args.recurrent):
        raise SystemExit("--normalize-obs/--normalize-reward are wired "
                         "into the (feedforward) PPO collect only")
    if args.algo == "a2c":
        from . import a2c

        if args.lr_anneal:
            raise SystemExit("--lr-anneal is wired into the PPO optimizer "
                             "only (A2C uses constant-lr RMSProp)")
        cfg = a2c.A2CConfig(rollout_steps=args.rollout_steps, lr=args.lr)
        tx = a2c.make_optimizer(cfg)
        if args.recurrent:
            iteration_fn = a2c.train_iteration_recurrent
            runner_specs = a2c.recurrent_runner_specs()
        else:
            iteration_fn = a2c.train_iteration
    elif args.recurrent:
        # Recurrent PPO (VERDICT r4 item 1a): clipped-surrogate epochs
        # minibatched over the sequence axis, BPTT from the rollout's
        # initial carry (recurrent_ppo.py).
        from . import a2c
        from . import recurrent_ppo as rppo

        cfg = rppo.RecurrentPPOConfig(
            rollout_steps=args.rollout_steps, lr=args.lr,
            epochs=args.epochs, minibatches=args.minibatches,
            lr_final=args.lr_final,
        )
        tx = rppo.make_optimizer(
            cfg, total_iters=args.iters if args.lr_anneal else None
        )
        iteration_fn = rppo.train_iteration_recurrent_ppo
        runner_specs = a2c.recurrent_runner_specs()
    else:
        cfg = PPOConfig(
            rollout_steps=args.rollout_steps, lr=args.lr, epochs=args.epochs,
            minibatches=args.minibatches, lr_final=args.lr_final,
        )
        # --lr-anneal reproduces the learning gate's schedule: linear
        # lr -> lr_final over the whole run (ADVICE r3 item 3)
        tx = make_optimizer(
            cfg, total_iters=args.iters if args.lr_anneal else None
        )
        from .ppo import train_iteration as iteration_fn

        if normalizing:
            import functools

            from .parallel import ppo_runner_specs
            from .parallel.mesh import ENV_AXIS
            from .ppo import make_normalized_collect

            iteration_fn = functools.partial(
                iteration_fn,
                collect_fn=make_normalized_collect(
                    normalize_obs=args.normalize_obs,
                    normalize_reward=args.normalize_reward,
                    axis_name=ENV_AXIS,
                ),
            )
            runner_specs = ppo_runner_specs(
                normalize_obs=args.normalize_obs,
                normalize_reward=args.normalize_reward,
            )
    # Per-team policy: self-play training controls both sides with one
    # shared policy through the mirrored view (ppo.collect_rollout).
    if args.recurrent:
        from . import a2c
        from .models.recurrent import RecurrentActorCritic

        model = RecurrentActorCritic(
            n_players=env_params.players_per_team,
            hidden=tuple(args.hidden), lstm_size=args.lstm_size,
        )
    else:
        model = ActorCritic(
            n_players=env_params.players_per_team, hidden=tuple(args.hidden)
        )
    mesh = make_mesh()
    if args.envs % jax.device_count():
        raise SystemExit(
            f"--envs {args.envs} must divide evenly over "
            f"{jax.device_count()} devices"
        )

    if args.recurrent:
        runner = a2c.init_recurrent_runner(
            jax.random.PRNGKey(args.seed), model, env_params, cfg,
            n_envs=args.envs, tx=tx,
        )
    else:
        runner = init_runner(
            jax.random.PRNGKey(args.seed), model, env_params, cfg,
            n_envs=args.envs, tx=tx,
            normalize_obs=args.normalize_obs,
            normalize_reward=args.normalize_reward,
        )
    runner = shard_runner(runner, mesh, runner_specs)
    step_fn = shard_train_iteration(
        mesh, model, env_params, cfg, tx, iteration_fn=iteration_fn,
        runner_specs=runner_specs,
    )

    ckpt = None
    if args.checkpoint_dir:
        from .utils.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir)
        restored, start_iter = ckpt.restore_latest(runner)
        if restored is not None:
            runner = restored
            print(f"# resumed from iteration {start_iter}")

    from .utils.metrics import MetricsLogger

    mlog = MetricsLogger(args.log_dir if jax.process_index() == 0 else None)

    steps_per_iter = args.envs * cfg.rollout_steps
    t_start = time.perf_counter()
    for it in range(args.iters):
        t0 = time.perf_counter()
        runner, metrics = step_fn(runner)
        metrics = jax.tree.map(float, jax.device_get(metrics))
        dt = time.perf_counter() - t0
        if it % args.log_every == 0 and jax.process_index() == 0:
            record = mlog.write(it, {
                "iter_s": round(dt, 4),
                "env_steps_per_sec": round(steps_per_iter / dt),
                **{k: round(v, 5) for k, v in metrics.items()},
            })
            print(json.dumps(record))
        if ckpt and (it + 1) % args.checkpoint_every == 0:
            ckpt.save(runner, it + 1)

    total = time.perf_counter() - t_start
    if jax.process_index() == 0:
        print(json.dumps({
            "done": True,
            "total_env_steps": steps_per_iter * args.iters,
            "wall_s": round(total, 2),
            "env_steps_per_sec": round(steps_per_iter * args.iters / total),
        }))
    mlog.close()
    if ckpt:
        ckpt.save(runner, args.iters)
        ckpt.wait()


if __name__ == "__main__":
    main()
