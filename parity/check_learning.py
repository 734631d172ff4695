"""End-to-end LEARNING gate: short self-play PPO runs must produce
policies that beat a random opponent, across seeds.

This is the product claim of an RL framework — metrics flowing and loss
decreasing are necessary but not sufficient. The gate

- trains ``--seeds`` independent seeds (default 3) and requires the MEAN
  trained-vs-random win rate >= ``--win-threshold`` (default 0.70);
- evaluates with ``evaluate.evaluate`` (the jnp joint-policy rollout)
  over ``--eval-envs`` full episodes (default 4096; binomial std ~0.7%);
- checks MONOTONICITY: the final policy must beat the policy
  checkpointed at 1/3 of training, head-to-head, for every seed;
- writes per-iteration learning curves to
  ``parity/artifacts/learning_curve_ppt{P}_seed{K}.jsonl``;
- after all seeds train, plays a trained-vs-trained cross-seed
  ROUND-ROBIN (league table in the output JSON and
  ``parity/artifacts/league_ppt{P}.json``) — evidence the seeds learned
  comparable, non-degenerate play, not just anything-beats-random.

``--ppt 3`` trains at 16384 envs (bench config 4 scale) and ``--ppt 5`` at
65536 envs (config 5 scale). Hyperparameters are recorded in the output
JSON.

Run:      python parity/check_learning.py [--ppt {2,3,5}]
Options:  --seeds N --iters N --envs B --win-threshold W --normalize
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from gym_futbol_tpu import EnvParams  # noqa: E402
from gym_futbol_tpu.evaluate import evaluate  # noqa: E402
from gym_futbol_tpu.models.policy import ActorCritic, make_policy_fn  # noqa: E402
from gym_futbol_tpu.ppo import (  # noqa: E402
    PPOConfig,
    collect_rollout,
    init_runner,
    make_optimizer,
    train_iteration,
)
from gym_futbol_tpu.utils.cache import enable_compilation_cache  # noqa: E402

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")


def train_one_seed(seed, args, env_params, cfg, model, tx, step_fn):
    """Train one seed; returns ((final_params, final_obs_norm),
    (one_third_params, one_third_obs_norm), curve). obs_norm entries are
    None unless --normalize (each checkpoint pairs with the frozen stats
    its policy acted through)."""
    runner = init_runner(
        jax.random.PRNGKey(seed), model, env_params, cfg,
        n_envs=args.envs, tx=tx,
        normalize_obs=args.normalize, normalize_reward=args.normalize,
    )
    third = max(1, args.iters // 3)
    snap_third = None
    curve = []
    snap = lambda r: (
        jax.tree.map(lambda x: x.copy(), r.params),
        jax.tree.map(lambda x: x.copy(), r.obs_norm),
    )
    for it in range(args.iters):
        runner, metrics = step_fn(runner)
        if it + 1 == third:
            snap_third = snap(runner)
        if it % args.log_every == 0 or it == args.iters - 1:
            m = {k: round(float(v), 5) for k, v in metrics.items()}
            curve.append({"iter": it, **m})
            print(f"# seed {seed} iter {it:4d}  {json.dumps(m)}", flush=True)
    return snap(runner), snap_third, curve


# Per-team-size defaults: env counts are the bench config scales.
PPT_DEFAULTS = {
    2: {"envs": 8192, "iters": 500},
    3: {"envs": 16384, "iters": 500},   # bench config 4 scale
    5: {"envs": 65536, "iters": 500},   # bench config 5 scale
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppt", type=int, default=2,
                    help="players per team (2/3/5 have tuned defaults)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--rollout-steps", type=int, default=128)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--win-threshold", type=float, default=0.70)
    ap.add_argument("--eval-envs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--normalize", action="store_true",
                    help="train WITH VecNormalize semantics end-to-end "
                         "(obs z-scoring + reward-by-return-std scaling; "
                         "ppo.make_normalized_collect) — the end-to-end "
                         "certification that the normalized path LEARNS")
    ap.add_argument("--no-league", action="store_true",
                    help="skip the trained-vs-trained round-robin")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args()
    enable_compilation_cache()

    defaults = PPT_DEFAULTS.get(args.ppt, PPT_DEFAULTS[2])
    if args.envs is None:
        args.envs = defaults["envs"]
    if args.iters is None:
        args.iters = defaults["iters"]

    env_params = EnvParams(players_per_team=args.ppt)
    cfg = PPOConfig(
        rollout_steps=args.rollout_steps, lr=args.lr, ent_coef=args.ent_coef,
    )
    model = ActorCritic(
        n_players=env_params.players_per_team, hidden=tuple(args.hidden)
    )
    tx = make_optimizer(cfg, total_iters=args.iters)
    collect_fn = collect_rollout
    if args.normalize:
        from gym_futbol_tpu.ppo import make_normalized_collect

        collect_fn = make_normalized_collect()
    step_fn = jax.jit(
        lambda r: train_iteration(
            r, model, env_params, cfg, tx, collect_fn=collect_fn,
        )
    )

    def jnp_policy(snap):
        params, obs_norm = snap
        policy = make_policy_fn(model, params)
        if obs_norm is None:
            return policy
        return lambda key, obs: policy(key, obs_norm.normalize(obs))

    def eval_vs_random(snap, n_envs, seed):
        return evaluate(env_params, policy_a=jnp_policy(snap),
                        n_envs=n_envs, n_steps=env_params.max_steps,
                        seed=seed)

    os.makedirs(ART_DIR, exist_ok=True)
    t0 = time.perf_counter()
    results = []
    final_params = []
    for k in range(args.seeds):
        seed = args.seed + 1000 * k
        snap, snap_third, curve = train_one_seed(
            seed, args, env_params, cfg, model, tx, step_fn
        )
        final_params.append(snap)
        suffix = "_norm" if args.normalize else ""
        with open(os.path.join(
                ART_DIR,
                f"learning_curve_ppt{args.ppt}{suffix}_seed{k}.jsonl"),
                "w") as f:
            for rec in curve:
                f.write(json.dumps(rec) + "\n")

        res = eval_vs_random(snap, args.eval_envs, seed + 7)
        win = float(res["win_rate_a"])

        # monotonicity: final head-to-head vs the 1/3-of-training policy
        mono = evaluate(
            env_params,
            policy_a=jnp_policy(snap),
            policy_b=jnp_policy(snap_third),
            n_envs=args.eval_envs, n_steps=env_params.max_steps,
            seed=seed + 11,
        )
        mono_ok = float(mono["win_rate_a"]) > float(mono["win_rate_b"])

        rec = {
            "seed": seed,
            "win_rate_vs_random": round(win, 4),
            "goals_per_episode": [round(float(g), 3)
                                  for g in res["goals_per_episode"]],
            "final_vs_third_win": round(float(mono["win_rate_a"]), 4),
            "third_vs_final_win": round(float(mono["win_rate_b"]), 4),
            "monotonic": mono_ok,
        }
        results.append(rec)
        print(f"# seed {seed}: {json.dumps(rec)}", flush=True)

    train_s = time.perf_counter() - t0

    # Trained-vs-trained cross-seed round-robin: each ordered pair plays
    # once (seed i as team 0 vs seed j as team 1), so side effects cancel
    # over the table.
    league = None
    if args.seeds > 1 and not args.no_league:
        league = {"pairs": [], "points": [0.0] * args.seeds}
        for i in range(args.seeds):
            for j in range(args.seeds):
                if i == j:
                    continue
                res = evaluate(
                    env_params,
                    policy_a=jnp_policy(final_params[i]),
                    policy_b=jnp_policy(final_params[j]),
                    n_envs=args.eval_envs,
                    n_steps=env_params.max_steps,
                    seed=9000 + 17 * i + j,
                )
                wa, wb = float(res["win_rate_a"]), float(res["win_rate_b"])
                dr = float(res["draw_rate"])
                league["pairs"].append({
                    "a": i, "b": j, "win_a": round(wa, 4),
                    "win_b": round(wb, 4), "draw": round(dr, 4),
                })
                league["points"][i] += wa + 0.5 * dr
                league["points"][j] += wb + 0.5 * dr
                print(f"# league: seed{i} vs seed{j}: "
                      f"{wa:.3f}/{dr:.3f}/{wb:.3f}", flush=True)
        games = 2 * (args.seeds - 1)
        league["points"] = [round(p / games, 4) for p in league["points"]]
        suffix = "_norm" if args.normalize else ""
        with open(os.path.join(
                ART_DIR, f"league_ppt{args.ppt}{suffix}.json"), "w") as f:
            json.dump(league, f, indent=1)

    wins = [r["win_rate_vs_random"] for r in results]
    mean_win = sum(wins) / len(wins)
    ok = mean_win >= args.win_threshold
    ok &= all(r["monotonic"] for r in results)
    print(json.dumps({
        "metric": ("normalized_trained_vs_random_win_rate_mean"
                   if args.normalize else "trained_vs_random_win_rate_mean"),
        "ppt": args.ppt,
        "value": round(mean_win, 4),
        "unit": (f"mean win rate over {args.seeds} seeds x "
                 f"{args.eval_envs} matches"),
        "threshold": args.win_threshold,
        "ok": ok,
        "per_seed": wins,
        "monotonic_all": all(r["monotonic"] for r in results),
        "league_points": league["points"] if league else None,
        "train_env_steps_per_seed": args.iters * args.envs
        * cfg.rollout_steps,
        "train_seconds_total": round(train_s, 1),
        "hyperparams": {"lr": args.lr, "lr_anneal": "linear->0.1*lr floor",
                        "ent_coef": args.ent_coef, "iters": args.iters,
                        "envs": args.envs,
                        "rollout_steps": args.rollout_steps,
                        "normalize": args.normalize},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
