"""Produce gameplay GIFs from a freshly-trained policy (user-facing demo).

Two phases, mirroring the library's platform split:

  python parity/make_demo.py            # GPU: train 2v2 self-play PPO,
                                        # save the policy weights .npz
  python parity/make_demo.py --render   # CPU: load the weights, render
                                        # trained-vs-random and
                                        # trained-vs-trained episodes to
                                        # parity/artifacts/*.gif

The .npz holds the policy layers (torso + logits head) as (W [in, out],
b [out, 1]) pairs. The render phase rebuilds an ``ActorCritic`` from them
and plays it through ``evaluate.joint_policy`` — the same
mirrored-perspective convention the training and evaluation stacks use.
SURVEY.md §2.1 #11 (rendering) is the reference row this demo exercises
end-to-end.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
WEIGHTS = os.path.join(ART_DIR, "demo_policy_weights.npz")
RWEIGHTS = os.path.join(ART_DIR, "demo_recurrent_weights.msgpack")


def train(args) -> None:
    import jax
    import numpy as np

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.ppo import (
        PPOConfig,
        init_runner,
        make_optimizer,
        train_iteration,
    )
    from gym_futbol_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    env_params = EnvParams(players_per_team=args.ppt)
    cfg = PPOConfig(rollout_steps=128, lr=3e-4, ent_coef=0.01)
    model = ActorCritic(n_players=args.ppt, hidden=(128, 128))
    tx = make_optimizer(cfg, total_iters=args.iters)
    runner = init_runner(
        jax.random.PRNGKey(args.seed), model, env_params, cfg,
        n_envs=args.envs, tx=tx,
    )
    step = jax.jit(lambda r: train_iteration(
        r, model, env_params, cfg, tx
    ))
    for it in range(args.iters):
        runner, metrics = step(runner)
        if it % 50 == 0 or it == args.iters - 1:
            print(f"# iter {it:4d} mean_reward "
                  f"{float(metrics['mean_reward']):+.4f}", flush=True)
    layers = runner.params["params"]
    w = []
    for i in range(len(model.hidden) + 1):     # torso + logits head
        w += [layers[f"Dense_{i}"]["kernel"], layers[f"Dense_{i}"]["bias"][:, None]]
    os.makedirs(ART_DIR, exist_ok=True)
    np.savez(WEIGHTS, *[np.asarray(x) for x in w], ppt=args.ppt)
    print(f"saved policy weights -> {WEIGHTS}")


def _recurrent_model(ppt: int):
    from gym_futbol_tpu.models.recurrent import RecurrentActorCritic

    return RecurrentActorCritic(n_players=ppt, hidden=(128,), lstm_size=128)


def train_recurrent(args) -> None:
    """Train the LSTM policy with recurrent PPO (recurrent_ppo.py) and
    save its variables with ``flax.serialization`` (SURVEY.md §3.5
    MlpLstmPolicy demo)."""
    import flax.serialization
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu import recurrent_ppo as rppo
    from gym_futbol_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    env_params = EnvParams(players_per_team=args.ppt)
    cfg = rppo.RecurrentPPOConfig(lr=3e-4)
    model = _recurrent_model(args.ppt)
    tx = rppo.make_optimizer(cfg, total_iters=args.iters)
    runner = rppo.init_recurrent_ppo_runner(
        jax.random.PRNGKey(args.seed), model, env_params, cfg,
        n_envs=args.envs, tx=tx,
    )
    step = jax.jit(lambda r: rppo.train_iteration_recurrent_ppo(
        r, model, env_params, cfg, tx
    ))
    for it in range(args.iters):
        runner, metrics = step(runner)
        if it % 100 == 0 or it == args.iters - 1:
            print(f"# iter {it:4d} mean_reward "
                  f"{float(metrics['mean_reward']):+.4f}", flush=True)
    os.makedirs(ART_DIR, exist_ok=True)
    with open(RWEIGHTS, "wb") as f:
        f.write(flax.serialization.to_bytes(
            {"ppt": args.ppt, "params": runner.params}
        ))
    print(f"saved recurrent policy -> {RWEIGHTS}")


def render_recurrent(args) -> None:
    """Render the saved recurrent policy vs random: the LSTM carry is
    threaded through render_episode's HOST loop by a stateful closure
    (one env, one episode — no resets mid-episode)."""
    import flax.serialization
    import jax

    jax.config.update("jax_platforms", "cpu")

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.evaluate import joint_policy, random_team_policy
    from gym_futbol_tpu.models.policy import sample_actions
    from gym_futbol_tpu.models.recurrent import init_recurrent_params
    from gym_futbol_tpu.render import render_episode, save_video

    params = EnvParams(players_per_team=args.ppt)
    model = _recurrent_model(args.ppt)
    template = {
        "ppt": args.ppt,
        "params": init_recurrent_params(
            jax.random.PRNGKey(0), model, params
        ),
    }
    with open(RWEIGHTS, "rb") as f:
        restored = flax.serialization.from_bytes(template, f.read())
    variables = restored["params"]

    def recurrent_team_policy():
        state = {"carry": model.initial_carry(1)}

        def policy(key, obs):
            state["carry"], (logits, _) = model.apply(
                variables, state["carry"], obs
            )
            acts, _ = sample_actions(key, logits)
            return acts

        return policy

    pol = joint_policy(params, recurrent_team_policy(),
                       random_team_policy(params))
    frames = render_episode(params, pol, seed=args.seed, every=2)
    path = save_video(
        frames, os.path.join(ART_DIR, "demo_recurrent_vs_random.gif"),
        fps=15,
    )
    print(f"demo_recurrent_vs_random: {len(frames)} frames -> {path}")


def render(args) -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.evaluate import joint_policy, random_team_policy
    from gym_futbol_tpu.models.policy import ActorCritic, make_policy_fn
    from gym_futbol_tpu.render import render_episode, save_video

    data = np.load(WEIGHTS)
    arrs = [data[f"arr_{i}"] for i in range(len(data.files) - 1)]
    ppt = int(data["ppt"])
    params = EnvParams(players_per_team=ppt)
    n = len(arrs) // 2 - 1                     # hidden layers
    layers = {f"Dense_{i}": {"kernel": arrs[2 * i], "bias": arrs[2 * i + 1][:, 0]}
              for i in range(n + 1)}
    # the value head plays no part in acting
    layers[f"Dense_{n + 1}"] = {"kernel": np.zeros((arrs[-2].shape[0], 1)),
                                "bias": np.zeros((1,))}
    model = ActorCritic(n_players=ppt,
                        hidden=tuple(a.shape[1] for a in arrs[0:-2:2]))
    trained = make_policy_fn(model, jax.tree.map(jax.numpy.asarray,
                                                 {"params": layers}))
    for name, opponent in (
        ("demo_trained_vs_random", random_team_policy(params)),
        ("demo_trained_vs_trained", trained),
    ):
        pol = joint_policy(params, trained, opponent)
        frames = render_episode(params, pol, seed=args.seed, every=2)
        path = save_video(frames, os.path.join(ART_DIR, f"{name}.gif"),
                          fps=15)
        print(f"{name}: {len(frames)} frames -> {path}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--render", action="store_true",
                    help="render GIFs from the saved weights (CPU)")
    ap.add_argument("--recurrent", action="store_true",
                    help="LSTM policy demo: train with recurrent PPO / "
                         "render with the carry-threading host loop")
    ap.add_argument("--ppt", type=int, default=2)
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.recurrent and args.iters == 500:
        args.iters = 1000  # the recurrent gate's certified budget
    if args.render and args.recurrent:
        render_recurrent(args)
    elif args.render:
        render(args)
    elif args.recurrent:
        train_recurrent(args)
    else:
        train(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
