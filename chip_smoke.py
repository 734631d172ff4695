"""Smoke test of the main path on one NVIDIA GPU, in phases.

    python chip_smoke.py               # phases a-e on one GPU
    python chip_smoke.py --four-gpus   # only the 4-GPU sharded PPO check

Phases (one process drives the card; no phase's failure is caught, so any
failure exits non-zero before the result line):

  a. device     JAX's devices are GPUs; prints the card's name and power
                limit (nvidia-smi), the JAX version and the compile cache.
  b. env        the jnp env.step in float64 on the card vs the C++ oracle
                (native/oracle.cpp) on random states, ppt 1, 2, 3, 5.
  c. kernel     the fused Triton rollout (ops/fused_rollout.py) vs the jnp
                path: replay one step and 32 steps from random mid-game
                states, random-mode statistics,
                the Triton custom call in the compiled HLO, timings of
                bench configs 2 and 3 for both implementations.
  d. train      python -m gym_futbol_tpu.train, called in this process:
                PPO 5v5 / 65536 envs and recurrent PPO 3v3 / 16384 envs;
                every loss finite.
  e. precision  the 5v5 ActorCritic forward under "highest" matmul
                precision vs a float64 numpy reference (rel err <= 1e-5),
                and how far the default (TF32) lies from it.

``--four-gpus`` runs two PPO iterations at 5v5 / 65536 global envs on a
4-GPU mesh, the same global batch and seed through the one-GPU emulation
of that mesh (parallel.emulate_sharded_iteration), compares losses,
parameter updates and the devices' parameter replicas, checks that the
same gates reject a control run without the gradient pmean, and measures
weak scaling 1 -> 4 GPUs.

The last line of standard output is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

# replay tolerances, relative to scale: positions / width, velocities /
# max_speed. One float32 ulp at 600 is ~6e-5 absolute (1e-7 of scale);
# the two paths differ by FMA contraction and libdevice math only.
REPLAY_STEP_TOL = 1e-5
# After 32 steps contacts have amplified ulp differences in a few envs:
# the 99th percentile of the per-env error must stay below this, and the
# integer state (possession, score, clock) must agree in >= 99% of envs.
REPLAY_TRAJ_TOL = 1e-3
REPLAY_TRAJ_AGREE = 0.99
STAT_SE = 4.0             # random-mode statistics agree within 4 SE
PRECISION_TOL = 1e-5      # "highest" forward vs float64, relative
# 4-GPU vs its one-GPU emulation: pmean summation order and TF32 matmul
# algorithm choice differ; Adam amplifies noise in near-zero gradients.
# The sound run read 2.0e-3 and 1 - 4.6e-5; every device applies the one
# pmean'd update, so the replicated parameters agree to rounding.
FOUR_LOSS_RTOL = 5e-3
FOUR_UPDATE_COS = 0.999
FOUR_REPLICA_TOL = 1e-6

# Sizes of each phase (full widths; a CPU rehearsal may shrink them).
SIZES = {
    "parity_states": 512,
    "replay_step": ((2, 4096), (5, 1024)),      # (ppt, envs), 1 step
    "replay_traj": (2, 4096, 32),               # ppt, envs, steps
    "random": (4096, 512),                      # envs, steps (2v2)
    "timing_configs": (2, 3),
    "train": (
        ("ppo_5v5", ["--ppt", "5", "--envs", "65536", "--rollout-steps",
                     "64", "--iters", "3"]),
        ("recurrent_3v3", ["--recurrent", "--ppt", "3", "--envs", "16384",
                           "--rollout-steps", "16", "--iters", "2"]),
    ),
    "precision_batch": 4096,
    "four_envs": 65536,                         # global, 5v5, 64 steps
}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------


def phase_device() -> tuple[dict, str]:
    import jax

    from gym_futbol_tpu.utils.cache import enable_compilation_cache
    from gym_futbol_tpu.utils.device import nvidia_smi, require_gpu

    dev = require_gpu()
    card = nvidia_smi()
    cache = enable_compilation_cache()
    log(f"[a] card: {card}")
    log(f"[a] jax {jax.__version__}; devices: {dev['device_count']} x "
        f"{dev['device_kind']}; compile cache: {cache}")
    return dev, card


# ---------------------------------------------------------------------------
# b. env parity vs the C++ oracle, float64 on the card
# ---------------------------------------------------------------------------


def phase_env() -> None:
    import jax

    from gym_futbol_tpu import EnvParams
    from native.build import load_oracle
    from parity.check_env_parity import TOL, batch_parity

    lib = load_oracle()
    with jax.enable_x64(True):
        for ppt in (1, 2, 3, 5):
            t0 = time.perf_counter()
            n = SIZES["parity_states"]
            r = batch_parity(lib, EnvParams(players_per_team=ppt), n,
                             seed=ppt)
            log(f"[b] ppt={ppt}: max err {r['max_err']:.3e} (gate {TOL:g}) "
                f"over {n} random states, {r['goals']} goals, "
                f"{r['dones']} dones, {time.perf_counter() - t0:.1f}s")
            assert r["max_err"] < TOL, f"env parity ppt={ppt}: {r}"
            assert r["goals"] > 0 and r["dones"] > 0, r


# ---------------------------------------------------------------------------
# c. fused Triton rollout vs the jnp path
# ---------------------------------------------------------------------------


def _jnp_replay(state, actions, params):
    import jax

    from gym_futbol_tpu import env as env_core

    def body(s, a):
        return jax.vmap(
            lambda s1, a1: env_core.step(s1, a1, params, auto_reset=True)
        )(s, a)

    return jax.jit(lambda s, a: jax.lax.scan(body, s, a))(state, actions)


def _scaled_err(got, ref, params):
    """Per-env max error of positions / width and velocities / max_speed."""
    import numpy as np

    dp = np.abs(np.asarray(got.pos) - np.asarray(ref.pos)) / params.width
    dv = np.abs(np.asarray(got.vel) - np.asarray(ref.vel)) / params.max_speed
    return np.maximum(dp.max(axis=(1, 2)), dv.max(axis=(1, 2)))


def _int_agree(got, ref):
    import numpy as np

    return (
        (np.asarray(got.possession) == np.asarray(ref.possession))
        & (np.asarray(got.score) == np.asarray(ref.score)).all(axis=1)
        & (np.asarray(got.t) == np.asarray(ref.t))
    )


def _replay(ppt: int, n_envs: int, n_steps: int):
    import jax

    import jax.numpy as jnp

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.ops import (
        fused_rollout_replay, pack_state, replay_actions, unpack_state,
    )
    from parity.check_env_parity import random_states

    params = EnvParams(players_per_team=ppt, kick_noise=0.0,
                       placement_noise=0.0)
    state, _ = random_states(jax.random.PRNGKey(ppt), params, n_envs,
                             jnp.float32)
    actions = jax.random.randint(
        jax.random.PRNGKey(100 + ppt), (n_steps, n_envs, params.n_players, 2),
        0, 5,
    )
    (ref, ref_out), t_ref = timed(_jnp_replay, state, actions, params)
    sf, si = pack_state(state, params)
    (sf2, si2, rew), t_k = timed(
        lambda: fused_rollout_replay(sf, si, replay_actions(actions), params)
    )
    got = unpack_state(sf2, si2, jax.random.PRNGKey(0), params)
    err = _scaled_err(got, ref, params)
    agree = _int_agree(got, ref)
    rew_err = float(abs(rew - ref_out.reward).max())
    log(f"[c] replay {ppt}v{ppt} x {n_envs} envs x {n_steps} steps: scaled "
        f"state err max {err.max():.3e} p99 {sorted(err)[int(.99 * n_envs)]:.3e}"
        f", reward err {rew_err:.3e}, integer state agrees in "
        f"{agree.mean():.4f} (compile+run: jnp {t_ref:.1f}s, triton "
        f"{t_k:.1f}s)")
    return err, agree, rew_err


def _random_stats(card: str):
    import jax
    import numpy as np

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.ops import fused_rollout, pack_state
    from gym_futbol_tpu.vector import random_policy, reset_batch, rollout

    params = EnvParams(players_per_team=2)
    b, t = SIZES["random"]
    state, _ = reset_batch(jax.random.PRNGKey(5), params, b)
    sf, si = pack_state(state, params)
    sf2, si2, rew = fused_rollout(sf, si, 7, params, t)
    run = jax.jit(lambda s, k: rollout(s, random_policy(params), k, params, t))
    ref_state, outs = run(state, jax.random.PRNGKey(9))
    k_rew = np.asarray(rew).mean(axis=0)             # per-env mean reward
    j_rew = np.asarray(outs.reward).mean(axis=0)
    k_si = np.asarray(si2)
    stats = {
        "mean reward": (k_rew, j_rew),
        "final score0": (k_si[1], np.asarray(ref_state.score[:, 0])),
        "final score1": (k_si[2], np.asarray(ref_state.score[:, 1])),
    }
    for name, (a, r) in stats.items():
        se = math.sqrt(a.var() / a.size + r.var() / r.size)
        z = abs(a.mean() - r.mean()) / max(se, 1e-12)
        log(f"[c] random {name}: triton {a.mean():.6f} jnp {r.mean():.6f} "
            f"({z:.2f} SE)")
        assert z <= STAT_SE, f"random-mode {name} differs by {z:.2f} SE"
    dones_k = int((k_si[3] == (t % params.max_steps)).sum())
    dones_j = int(np.asarray(outs.done).sum())
    log(f"[c] random dones: triton clock agrees in {dones_k}/{b} envs, jnp "
        f"{dones_j} dones")
    assert dones_k == b and dones_j == b * (t // params.max_steps)
    assert np.array_equal(k_si[3], np.asarray(ref_state.t))


def _lowering() -> None:
    import jax

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.ops import fused_rollout, pack_state
    from gym_futbol_tpu.vector import reset_batch

    params = EnvParams(players_per_team=2)
    b, t = SIZES["random"]
    state, _ = reset_batch(jax.random.PRNGKey(0), params, b)
    sf, si = pack_state(state, params)
    hlo = fused_rollout.lower(sf, si, 1, params, t).compile().as_text()
    calls = [ln for ln in hlo.splitlines() if "triton" in ln.lower()]
    log(f"[c] compiled HLO: {len(calls)} line(s) name the Triton custom call")
    assert calls, "no Triton custom call in the compiled fused rollout"


def _timings(card: str) -> None:
    import bench

    for config in SIZES["timing_configs"]:
        for impl in ("jnp", "triton"):
            # 40 iterations where one takes milliseconds (bench.py's rule)
            iters = 40 if (config, impl) == (2, "triton") else 10
            args = argparse.Namespace(**bench.CONFIGS[config], iters=iters,
                                      verbose=False)
            run = (bench.bench_rollout_triton if impl == "triton"
                   else bench.bench_rollout_jnp)
            log(f"[c] config {config} {impl}: {run(args):.0f} env-steps/s "
                f"on {card}")


def phase_kernel(card: str) -> None:
    for ppt, n_envs in SIZES["replay_step"]:
        err, agree, rew_err = _replay(ppt, n_envs, 1)
        assert err.max() <= REPLAY_STEP_TOL and agree.all(), err.max()
    err, agree, _ = _replay(*SIZES["replay_traj"])
    assert sorted(err)[int(0.99 * err.size)] <= REPLAY_TRAJ_TOL, err
    assert agree.mean() >= REPLAY_TRAJ_AGREE, agree.mean()
    _random_stats(card)
    _lowering()
    _timings(card)


# ---------------------------------------------------------------------------
# d. training through the CLI entry point, in this process
# ---------------------------------------------------------------------------


def _train(name: str, argv: list[str], card: str) -> None:
    from gym_futbol_tpu import train

    log_dir = os.path.join(OUT, name)
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    train.main([*argv, "--log-dir", log_dir])
    wall = time.perf_counter() - t0
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        for k in ("loss", "pg_loss", "v_loss", "entropy"):
            assert math.isfinite(r[k]), f"{name}: non-finite {k} in {r}"
    steady = recs[-1]["iter_s"]
    log(f"[d] {name}: {len(recs)} iterations, losses "
        f"{[r['loss'] for r in recs]}; first iteration {recs[0]['iter_s']:.1f}s"
        f" (compile ~{recs[0]['iter_s'] - steady:.1f}s), steady "
        f"{recs[-1]['env_steps_per_sec']} env-steps/s on {card}; "
        f"wall {wall:.1f}s")


def phase_train(card: str) -> None:
    for name, argv in SIZES["train"]:
        _train(name, argv, card)


# ---------------------------------------------------------------------------
# e. matmul precision
# ---------------------------------------------------------------------------


def _forward64(params, obs):
    import numpy as np

    p = {k: {n: np.asarray(v, np.float64) for n, v in layer.items()}
         for k, layer in params["params"].items()}
    x = np.asarray(obs, np.float64)
    for i in range(2):
        x = np.tanh(x @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"])
    return (x @ p["Dense_2"]["kernel"] + p["Dense_2"]["bias"],
            (x @ p["Dense_3"]["kernel"] + p["Dense_3"]["bias"])[:, 0])


def phase_precision() -> None:
    import jax
    import numpy as np

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.env import obs_size
    from gym_futbol_tpu.models.policy import ActorCritic, init_params

    env_params = EnvParams(players_per_team=5)
    model = ActorCritic(n_players=5)
    params = init_params(jax.random.PRNGKey(0), model, env_params)
    obs = jax.random.normal(jax.random.PRNGKey(1),
                            (SIZES["precision_batch"], obs_size(env_params)))
    ref_l, ref_v = _forward64(params, obs)
    fwd = jax.jit(model.apply)

    def rel(out):
        return max(
            float(np.abs(np.asarray(out[0], np.float64) - ref_l).max()
                  / np.abs(ref_l).max()),
            float(np.abs(np.asarray(out[1], np.float64) - ref_v).max()
                  / np.abs(ref_v).max()),
        )

    with jax.default_matmul_precision("highest"):
        high = rel(jax.jit(model.apply)(params, obs))
    default = rel(fwd(params, obs))
    log(f"[e] 5v5 ActorCritic forward vs float64: highest {high:.3e} "
        f"(gate {PRECISION_TOL:g}), default precision {default:.3e}")
    assert high <= PRECISION_TOL, high


# ---------------------------------------------------------------------------
# --four-gpus: sharded PPO on 4 GPUs vs its one-GPU emulation
# ---------------------------------------------------------------------------


def _replica_spread(tree) -> float:
    """Max |copy on device d - copy on device 0| over a replicated tree:
    with the gradient pmean every device applies the same update."""
    import jax
    import numpy as np

    return max(
        float(np.abs(np.asarray(s.data)
                     - np.asarray(x.addressable_shards[0].data)).max())
        for x in jax.tree.leaves(tree) for s in x.addressable_shards
    )


def _four_gates(runner, losses, ref_losses, ref_update, p0) -> dict:
    """Each 4-GPU gate: name -> (reading, passes)."""
    import numpy as np

    d = _flat(runner.params) - p0
    cos = float(d @ ref_update
                / (np.linalg.norm(d) * np.linalg.norm(ref_update)))
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    spread = _replica_spread(runner.params)
    return {
        "loss rel err": (loss, loss <= FOUR_LOSS_RTOL),
        "update cosine": (cos, cos >= FOUR_UPDATE_COS),
        "replica spread": (spread, spread <= FOUR_REPLICA_TOL),
    }


def _flat(params):
    import jax
    import numpy as np

    return np.concatenate(
        [np.ravel(x) for x in jax.tree.leaves(jax.device_get(params))])


def _checksum(params) -> float:
    import numpy as np

    return float(np.abs(_flat(params)).sum())


def _two_iterations(fn, runner, label: str):
    losses = []
    for it in range(2):
        (runner, m), dt = timed(fn, runner)
        losses.append(float(m["loss"]))
        log(f"[4] {label} iteration {it}: loss {losses[-1]:.6f} ({dt:.2f}s)")
    return runner, losses


def four_gpus(card: str) -> None:
    import jax

    import bench
    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.parallel import (
        emulate_sharded_iteration, make_mesh, shard_runner,
        shard_train_iteration,
    )
    from gym_futbol_tpu.ppo import (
        PPOConfig, init_runner, make_optimizer, train_iteration,
    )

    devices = jax.devices()
    assert len(devices) >= 4, f"--four-gpus needs 4 GPUs, found {devices}"
    env_params = EnvParams(players_per_team=5)
    cfg = PPOConfig(rollout_steps=64)
    model = ActorCritic(n_players=5)
    tx = make_optimizer(cfg)
    n_envs = SIZES["four_envs"]

    def runner(n, mesh=None):
        r = init_runner(jax.random.PRNGKey(0), model, env_params, cfg,
                        n_envs=n, tx=tx)
        return r if mesh is None else shard_runner(r, mesh)

    def per_shard(r, model, env_params, cfg, tx, axis_name):
        # control: the same iteration without the gradient pmean
        return train_iteration(r, model, env_params, cfg, tx)

    p0 = _flat(runner(n_envs).params)
    mesh4, mesh1 = make_mesh(devices[:4]), make_mesh(devices[:1])
    programs = {
        "4 GPUs": (shard_train_iteration(mesh4, model, env_params, cfg, tx),
                   runner(n_envs, mesh4)),
        "emulation": (emulate_sharded_iteration(4, model, env_params, cfg,
                                                tx), runner(n_envs)),
        "control": (shard_train_iteration(mesh4, model, env_params, cfg, tx,
                                          iteration_fn=per_shard),
                    runner(n_envs, mesh4)),
        # weak-scaling baseline: a quarter of the envs on one GPU
        "1 GPU": (shard_train_iteration(mesh1, model, env_params, cfg, tx),
                  runner(n_envs // 4, mesh1)),
    }
    # the programs compile concurrently (compilation runs on the host's
    # cores and releases the interpreter lock)
    with ThreadPoolExecutor(len(programs)) as ex:
        futures = {k: ex.submit(lambda f, r: f.lower(r).compile(), f, r)
                   for k, (f, r) in programs.items()}
        fns = {k: f.result() for k, f in futures.items()}
    runners = {k: r for k, (_, r) in programs.items()}

    r1, ref_losses = _two_iterations(fns["emulation"], runners["emulation"],
                                     "one-GPU emulation")
    ref_update = _flat(r1.params) - p0
    results = {}
    for name in ("4 GPUs", "control"):
        runners[name], losses = _two_iterations(fns[name], runners[name],
                                                name)
        results[name] = _four_gates(runners[name], losses, ref_losses,
                                    ref_update, p0)
        log(f"[4] {name} vs emulation: " + ", ".join(
            f"{k} {v:.6g} ({'pass' if ok else 'FAIL'})"
            for k, (v, ok) in results[name].items())
            + f"; parameter checksum {_checksum(runners[name].params):.6f}, "
            f"emulation {_checksum(r1.params):.6f}")
    failed = [k for k, (_, ok) in results["4 GPUs"].items() if not ok]
    assert not failed, f"4 GPUs fail {failed}: {results['4 GPUs']}"
    caught = [k for k, (_, ok) in results["control"].items() if not ok]
    log(f"[4] control without the pmean fails: {caught}")
    assert caught, f"the gates miss a lost pmean: {results['control']}"

    # weak scaling: n_envs / 4 envs per GPU on 1 and on 4 GPUs
    rates = {}
    for d, name in ((4, "4 GPUs"), (1, "1 GPU")):
        def once(r, i, fn=fns[name]):
            r, m = fn(r)
            return r, m["loss"]

        dt = bench._time(once, runners[name], 3, False, name)
        rates[d] = n_envs // 4 * d * cfg.rollout_steps / dt
    log(f"[4] weak scaling, {n_envs // 4} envs per GPU: 1 GPU {rates[1]:.0f}, "
        f"4 GPUs {rates[4]:.0f} env-steps/s; efficiency "
        f"{rates[4] / (4 * rates[1]):.3f} on {card}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU sharded PPO comparison")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    os.makedirs(OUT, exist_ok=True)

    t_all = time.perf_counter()
    dev, card = phase_device()
    phases = ([("4-gpu", lambda: four_gpus(card))] if args.four_gpus else [
        ("b env", phase_env),
        ("c kernel", lambda: phase_kernel(card)),
        ("d train", lambda: phase_train(card)),
        ("e precision", phase_precision),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"# phase {name}: {time.perf_counter() - t0:.1f}s")
    log(f"# total {time.perf_counter() - t_all:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["device_kind"],
        "count": dev["device_count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
