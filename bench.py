"""Throughput benchmark — the bench configs (headline: config 3).

Prints the card's name and power limit (``nvidia-smi``), then exactly ONE
JSON record on the last output line:

    {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
     "config": C, "impl": "...", "platform": "gpu", "device_kind": "...",
     "device_count": D}

Configs (--config):
  2: 2v2, 256 envs, 512 steps, random-policy rollout with auto-reset
  3: 2v2, 4096 envs, 512 steps, random-policy rollout (the headline)
  4: 3v3, 16384 envs, 128 steps, PPO rollout-buffer collection + GAE
  5: 5v5, 65536 envs, 64 steps, full sharded PPO iteration (grad pmean)
  6: 2v2, 4096 envs, 512 steps, policy-vs-policy self-play: two 256x256
     ActorCritic team policies on the jnp rollout (evaluate._run_matches)

Configs 2-3 take ``--impl jnp`` (vector.rollout under jit+lax.scan) or
``--impl triton`` (the fused Pallas rollout kernel, ops/fused_rollout.py);
configs 4-6 run the jnp path only. An implementation that cannot run
here is refused, never replaced by another, and so is any platform but
a GPU.

Usage: python bench.py [--config 3] [--impl triton] [--envs N] [--steps T]
"""

from __future__ import annotations

import argparse
import json
import time

CONFIGS = {
    2: dict(ppt=2, envs=256, steps=512),
    3: dict(ppt=2, envs=4096, steps=512),
    4: dict(ppt=3, envs=16384, steps=128),
    5: dict(ppt=5, envs=65536, steps=64),
    6: dict(ppt=2, envs=4096, steps=512),
}
ROLLOUT_CONFIGS = (2, 3)
IMPLS = ("jnp", "triton")


def _time(once, state, iters: int, verbose: bool, label: str):
    """Compile + first run, one more warmup (the first post-compile call
    can re-specialize on the carried state's layout), then ``iters``
    timed calls chained through the state. Returns seconds per call."""
    import jax

    t0 = time.perf_counter()
    state, out = once(state, 0)
    jax.block_until_ready(out)
    if verbose:
        print(f"# {label} compile+first-run: {time.perf_counter() - t0:.2f}s")
    state, out = once(state, 1)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(iters):
        state, out = once(state, 2 + i)
    jax.block_until_ready((state, out))
    return (time.perf_counter() - t0) / iters


def bench_rollout_triton(args) -> float:
    """Configs 2-3 on the fused rollout kernel. Returns steps/s."""
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.ops import fused_rollout, pack_state
    from gym_futbol_tpu.vector import reset_batch

    params = EnvParams(players_per_team=args.ppt)
    state, _ = reset_batch(jax.random.PRNGKey(0), params, args.envs)

    def once(packed, i):
        sf, si, rew = fused_rollout(*packed, i, params, args.steps)
        return (sf, si), rew

    dt = _time(once, pack_state(state, params), args.iters, args.verbose,
               "triton")
    return args.envs * args.steps / dt


def bench_rollout_jnp(args) -> float:
    """Configs 2-3 on vector.rollout. Returns steps/s."""
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.parallel import make_mesh, shard_env_state, shard_rollout
    from gym_futbol_tpu.vector import reset_batch

    params = EnvParams(players_per_team=args.ppt)
    mesh = make_mesh()
    run = shard_rollout(mesh, params, args.steps)
    state, _ = reset_batch(jax.random.PRNGKey(0), params, args.envs)

    def once(state, i):
        state, outs = run(state, jax.random.PRNGKey(1 + i))
        return state, outs.reward

    dt = _time(once, shard_env_state(state, mesh), args.iters, args.verbose,
               "jnp")
    return args.envs * args.steps / dt


def bench_selfplay(args) -> float:
    """Config 6: two ActorCritic team policies playing each other on the
    jnp rollout (evaluate._run_matches). Returns steps/s."""
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.evaluate import _run_matches, joint_policy
    from gym_futbol_tpu.models.policy import (
        ActorCritic, init_params, make_policy_fn,
    )

    params = EnvParams(players_per_team=args.ppt)
    model = ActorCritic(n_players=params.players_per_team)
    policy = joint_policy(
        params,
        make_policy_fn(model, init_params(jax.random.PRNGKey(1), model,
                                          params)),
        make_policy_fn(model, init_params(jax.random.PRNGKey(2), model,
                                          params)),
    )

    def once(state, i):
        out = _run_matches(jax.random.PRNGKey(i), params, args.envs,
                           args.steps, policy)
        return state, out["goals"]

    dt = _time(once, None, args.iters, args.verbose, "selfplay")
    return args.envs * args.steps / dt


def bench_ppo(args, with_update: bool) -> float:
    """Config 4 (rollout collection into the PPO buffer + GAE) and
    config 5 (full sharded PPO iteration). Returns env-steps/s."""
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.parallel import (
        make_mesh, shard_runner, shard_train_iteration,
    )
    from gym_futbol_tpu.ppo import (
        PPOConfig, collect_rollout, compute_gae, init_runner, make_optimizer,
    )

    env_params = EnvParams(players_per_team=args.ppt)
    cfg = PPOConfig(rollout_steps=args.steps)
    # per-team policy (self-play; ppo.collect_rollout docstring)
    model = ActorCritic(n_players=env_params.players_per_team)
    tx = make_optimizer(cfg)
    mesh = make_mesh()
    runner = init_runner(
        jax.random.PRNGKey(0), model, env_params, cfg, n_envs=args.envs, tx=tx
    )
    runner = shard_runner(runner, mesh)

    if with_update:
        fn = shard_train_iteration(mesh, model, env_params, cfg, tx)

        def once(r, i):
            r, metrics = fn(r)
            return r, metrics["loss"]
    else:
        @jax.jit
        def collect(r):
            r, traj, last_v = collect_rollout(r, model, env_params, cfg)
            adv, _ = compute_gae(traj, last_v, cfg)
            return r, adv.mean()

        def once(r, i):
            return collect(r)

    dt = _time(once, runner, args.iters, args.verbose, "ppo")
    return args.envs * args.steps / dt


def bench_scaling(args) -> dict:
    """--scaling: WEAK-scaling sweep over device counts.

    Runs the full sharded PPO iteration (the only code path with a
    collective) on meshes of 1, 2, 4, ... of the visible devices with a
    FIXED per-device env count, and reports throughput efficiency vs the
    1-device run. One process drives every device: the sweep never starts
    a second process on a card.
    """
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.parallel import (
        make_mesh, shard_runner, shard_train_iteration,
    )
    from gym_futbol_tpu.ppo import PPOConfig, init_runner, make_optimizer

    devices = jax.devices()
    counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= len(devices)]
    per_dev = args.envs or 512
    steps = args.steps or 32

    env_params = EnvParams(players_per_team=args.ppt or 2)
    cfg = PPOConfig(rollout_steps=steps)
    model = ActorCritic(n_players=env_params.players_per_team)
    tx = make_optimizer(cfg)

    rates = {}
    for d in counts:
        mesh = make_mesh(devices[:d])
        n_envs = per_dev * d
        runner = init_runner(
            jax.random.PRNGKey(0), model, env_params, cfg, n_envs=n_envs,
            tx=tx,
        )
        runner = shard_runner(runner, mesh)
        fn = shard_train_iteration(mesh, model, env_params, cfg, tx)

        def once(r, i):
            r, m = fn(r)
            return r, m["loss"]

        dt = _time(once, runner, args.iters, args.verbose, f"{d} dev")
        rates[d] = n_envs * steps / dt
        eff = rates[d] / (d * rates[1])
        print(f"# scaling {d:3d} dev x {per_dev} envs: "
              f"{rates[d]:12.0f} steps/s  efficiency {eff:6.3f}")

    d_max = counts[-1]
    return {
        "metric": "weak_scaling_efficiency",
        "value": rates[d_max] / (d_max * rates[1]),
        "unit": f"fraction of linear at {d_max} devices "
                f"({per_dev} envs/device)",
        "steps_per_sec": {str(d): r for d, r in rates.items()},
    }


def check_impl(config: int, impl: str) -> None:
    """Refuse an implementation the config cannot run."""
    if impl == "triton" and config not in ROLLOUT_CONFIGS:
        raise SystemExit(f"--impl triton: config {config} has only the jnp "
                         f"path (the kernel runs configs {ROLLOUT_CONFIGS})")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3, choices=sorted(CONFIGS))
    ap.add_argument("--scaling", action="store_true",
                    help="weak-scaling efficiency sweep over device counts; "
                         "--envs becomes envs-per-device (default 512)")
    ap.add_argument("--impl", choices=IMPLS, default=None,
                    help="rollout implementation for configs 2-3 (default "
                         "triton); configs 4-6 run jnp only")
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ppt", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None,
                    help="timed iterations (default 10; 40 for config 2, "
                         "whose iterations are short against the one final "
                         "sync)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from gym_futbol_tpu.utils.cache import enable_compilation_cache
    from gym_futbol_tpu.utils.device import device_record, nvidia_smi

    enable_compilation_cache()
    dev = device_record()
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py times the GPU; JAX found "
                         f"{dev['platform']}")
    print(f"# card: {nvidia_smi()}")

    if args.scaling:
        if args.iters is None:
            args.iters = 10
        record = {**bench_scaling(args), **dev}
        print(json.dumps(record))
        return record

    preset = CONFIGS[args.config]
    args.envs = args.envs or preset["envs"]
    args.steps = args.steps or preset["steps"]
    args.ppt = args.ppt or preset["ppt"]
    if args.iters is None:
        args.iters = 40 if args.config == 2 else 10
    impl = args.impl or ("triton" if args.config in ROLLOUT_CONFIGS else "jnp")
    check_impl(args.config, impl)

    if args.config in ROLLOUT_CONFIGS:
        run = bench_rollout_triton if impl == "triton" else bench_rollout_jnp
        steps_per_sec = run(args)
    elif args.config == 6:
        steps_per_sec = bench_selfplay(args)
    else:
        steps_per_sec = bench_ppo(args, with_update=args.config == 5)

    record = {
        "metric": "env_steps_per_sec",
        "value": steps_per_sec,
        "unit": "steps/s",
        "config": args.config,
        "impl": impl,
        **dev,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
