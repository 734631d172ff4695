"""Recurrent learning gate — the LSTM path held to the SAME bar as the
MLP path (VERDICT r4 item 1): multi-seed self-play training at 2v2 scale
must beat a random opponent AND its own 1/3-of-training checkpoint.

Two algorithms share the gate (one per invocation, ``--algo``):

- ``a2c``: full-batch BPTT A2C (``a2c.train_iteration_recurrent``) — the
  stable-baselines MlpLstmPolicy+A2C analog;
- ``ppo``: sequence-minibatched clipped-surrogate recurrent PPO
  (``recurrent_ppo.train_iteration_recurrent_ppo``) — the
  MlpLstmPolicy+PPO2 analog (SURVEY.md §3.5).

Gate shape mirrors parity/check_learning.py: ``--seeds`` independent
seeds (default 3), mean trained-vs-random win rate >= ``--win-threshold``
(default 0.70) on the carry-threading evaluator
(evaluate.evaluate_recurrent), per-seed MONOTONICITY (final policy must
beat the 1/3-of-training checkpoint head-to-head, recurrent-vs-recurrent
via ``variables_b``), learning curves committed to
``parity/artifacts/recurrent_curve_ppt{P}_{algo}_seed{K}.jsonl``, and an
optional cross-seed league.

Run:        python parity/check_recurrent_learning.py --algo ppo
            python parity/check_recurrent_learning.py --algo a2c
CPU smoke:  python parity/check_recurrent_learning.py --algo ppo \
                --ppt 1 --iters 3 --envs 8 --eval-envs 8 --seeds 1 \
                --win-threshold 0
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
from gym_futbol_tpu import a2c  # noqa: E402
from gym_futbol_tpu import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu.evaluate import evaluate_recurrent  # noqa: E402
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu.utils.cache import enable_compilation_cache  # noqa: E402

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")

# Tuned per-team-size budgets.
# PPO takes 8 gradient steps per iteration vs A2C's 1, so it needs fewer
# iterations for the same wall/win; envs follow the MLP 2v2 gate (8192).
PPT_DEFAULTS = {
    1: {"envs": 4096, "iters": {"a2c": 3000, "ppo": 800}},
    2: {"envs": 8192, "iters": {"a2c": 4000, "ppo": 1000}},
    3: {"envs": 16384, "iters": {"a2c": 6000, "ppo": 2000}},  # config-4 scale
    5: {"envs": 65536, "iters": {"a2c": 6000, "ppo": 2000}},  # config-5 scale
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("a2c", "ppo"), default="ppo")
    ap.add_argument("--ppt", type=int, default=2,
                    help="players per team (1/2/3 have tuned defaults; "
                         "3 runs at the BASELINE config-4 env scale)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--rollout-steps", type=int, default=16)
    ap.add_argument("--lstm-size", type=int, default=128)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128])
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 7e-4 (a2c) / 3e-4 (ppo)")
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--win-threshold", type=float, default=0.70)
    ap.add_argument("--eval-envs", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--no-league", action="store_true")
    ap.add_argument("--log-every", type=int, default=100)
    args = ap.parse_args()
    enable_compilation_cache()

    defaults = PPT_DEFAULTS.get(args.ppt, PPT_DEFAULTS[2])
    if args.envs is None:
        args.envs = defaults["envs"]
    if args.iters is None:
        args.iters = defaults["iters"][args.algo]
    if args.lr is None:
        args.lr = 7e-4 if args.algo == "a2c" else 3e-4

    env_params = EnvParams(players_per_team=args.ppt)
    model = RecurrentActorCritic(
        n_players=env_params.players_per_team, hidden=tuple(args.hidden),
        lstm_size=args.lstm_size,
    )
    if args.algo == "a2c":
        cfg = a2c.A2CConfig(rollout_steps=args.rollout_steps, lr=args.lr,
                            ent_coef=args.ent_coef)
        tx = a2c.make_optimizer(cfg)
        iteration = lambda r: a2c.train_iteration_recurrent(
            r, model, env_params, cfg, tx
        )
    else:
        cfg = rppo.RecurrentPPOConfig(
            rollout_steps=args.rollout_steps, lr=args.lr,
            ent_coef=args.ent_coef,
        )
        tx = rppo.make_optimizer(cfg, total_iters=args.iters)
        iteration = lambda r: rppo.train_iteration_recurrent_ppo(
            r, model, env_params, cfg, tx
        )
    step_fn = jax.jit(iteration)

    def eval_vs_random(params, seed):
        return evaluate_recurrent(
            env_params, model, params, n_envs=args.eval_envs,
            n_steps=env_params.max_steps, seed=seed,
        )

    os.makedirs(ART_DIR, exist_ok=True)
    t0 = time.perf_counter()
    results, final_params = [], []
    for k in range(args.seeds):
        seed = args.seed + 1000 * k
        runner = a2c.init_recurrent_runner(
            jax.random.PRNGKey(seed), model, env_params, cfg,
            n_envs=args.envs, tx=tx,
        )
        third = max(1, args.iters // 3)
        params_third, curve = None, []
        for it in range(args.iters):
            runner, metrics = step_fn(runner)
            if it + 1 == third:
                params_third = jax.tree.map(lambda x: x.copy(),
                                            runner.params)
            if it % args.log_every == 0 or it == args.iters - 1:
                m = {kk: round(float(v), 5) for kk, v in metrics.items()}
                curve.append({"iter": it, **m})
                print(f"# seed {seed} iter {it:5d}  {json.dumps(m)}",
                      flush=True)
        final_params.append(runner.params)
        with open(os.path.join(
                ART_DIR, f"recurrent_curve_ppt{args.ppt}_{args.algo}"
                         f"_seed{k}.jsonl"), "w") as f:
            for rec in curve:
                f.write(json.dumps(rec) + "\n")

        res = eval_vs_random(runner.params, seed + 7)
        win = float(res["win_rate_a"])
        mono = evaluate_recurrent(
            env_params, model, runner.params, variables_b=params_third,
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

    league = None
    if args.seeds > 1 and not args.no_league:
        league = {"pairs": [], "points": [0.0] * args.seeds}
        for i in range(args.seeds):
            for j in range(args.seeds):
                if i == j:
                    continue
                res = evaluate_recurrent(
                    env_params, model, final_params[i],
                    variables_b=final_params[j], n_envs=args.eval_envs,
                    n_steps=env_params.max_steps, seed=9000 + 17 * i + j,
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
        with open(os.path.join(
                ART_DIR,
                f"recurrent_league_ppt{args.ppt}_{args.algo}.json"),
                "w") as f:
            json.dump(league, f, indent=1)

    wins = [r["win_rate_vs_random"] for r in results]
    mean_win = sum(wins) / len(wins)
    ok = mean_win >= args.win_threshold
    ok &= all(r["monotonic"] for r in results)
    print(json.dumps({
        "metric": f"recurrent_{args.algo}_trained_vs_random_win_rate_mean",
        "ppt": args.ppt,
        "value": round(mean_win, 4),
        "unit": (f"mean win rate over {args.seeds} seeds x "
                 f"{args.eval_envs} matches (LSTM {args.algo})"),
        "threshold": args.win_threshold,
        "ok": ok,
        "per_seed": wins,
        "monotonic_all": all(r["monotonic"] for r in results),
        "league_points": league["points"] if league else None,
        "train_env_steps_per_seed": args.iters * args.envs
        * cfg.rollout_steps,
        "train_seconds_total": round(train_s, 1),
        "hyperparams": {"algo": args.algo, "lr": args.lr,
                        "ent_coef": args.ent_coef, "iters": args.iters,
                        "envs": args.envs, "lstm_size": args.lstm_size,
                        "hidden": args.hidden,
                        "rollout_steps": args.rollout_steps},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
