"""chip_smoke.py: the GPU smoke test refuses any other platform and
prints no result line unless every phase ran."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_rejects_cpu(capsys):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_lone_script_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_replay_error_is_scaled_per_env():
    """Phase c's replay metric: positions over width, velocities over
    max_speed, the worst coordinate of each env."""
    import numpy as np

    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.vector import reset_batch

    params = EnvParams()
    ref, _ = reset_batch(jax.random.PRNGKey(0), params, 3)
    got = ref.replace(pos=ref.pos.at[1, 2, 0].add(6.0),
                      vel=ref.vel.at[2, 0, 1].add(-50.0))
    err = chip_smoke._scaled_err(got, ref, params)
    np.testing.assert_allclose(err, [0.0, 6.0 / 600.0, 50.0 / 500.0],
                               rtol=1e-5)
    agree = chip_smoke._int_agree(got.replace(t=got.t.at[0].add(1)), ref)
    assert agree.tolist() == [False, True, True]


def test_help_lists_four_gpu_option():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--help"],
        capture_output=True, text=True, timeout=300,
    ).stdout
    assert "--four-gpus" in out


def test_four_gpu_gates_catch_a_lost_pmean():
    """--four-gpus gates on 4 CPU devices: the sharded iteration passes
    against its one-device emulation; the same iteration without the
    gradient pmean fails, its parameter replicas apart."""
    from gym_futbol_tpu import EnvParams
    from gym_futbol_tpu.models.policy import ActorCritic
    from gym_futbol_tpu.parallel import (
        emulate_sharded_iteration, make_mesh, shard_runner,
        shard_train_iteration,
    )
    from gym_futbol_tpu.ppo import (
        PPOConfig, init_runner, make_optimizer, train_iteration,
    )

    env_params = EnvParams(players_per_team=2, max_steps=16)
    cfg = PPOConfig(rollout_steps=4, epochs=2, minibatches=2, shuffle_block=8)
    model = ActorCritic(n_players=2, hidden=(16,))
    tx = make_optimizer(cfg)
    mesh = make_mesh(jax.devices()[:4])
    make = lambda: init_runner(jax.random.PRNGKey(0), model, env_params, cfg,
                               n_envs=64, tx=tx)

    def per_shard(r, model, env_params, cfg, tx, axis_name):
        return train_iteration(r, model, env_params, cfg, tx)

    p0 = chip_smoke._flat(make().params)
    emu = emulate_sharded_iteration(4, model, env_params, cfg, tx)
    r1, ref_losses = chip_smoke._two_iterations(emu, make(), "emulation")
    ref_update = chip_smoke._flat(r1.params) - p0
    gates = {}
    for name, fn_kw in (("sound", {}), ("control", {"iteration_fn": per_shard})):
        fn = shard_train_iteration(mesh, model, env_params, cfg, tx, **fn_kw)
        r, losses = chip_smoke._two_iterations(fn, shard_runner(make(), mesh),
                                               name)
        gates[name] = chip_smoke._four_gates(r, losses, ref_losses,
                                             ref_update, p0)
    assert all(ok for _, ok in gates["sound"].values()), gates["sound"]
    assert gates["sound"]["replica spread"][0] == 0.0
    spread, ok = gates["control"]["replica spread"]
    assert not ok and spread > 1e3 * chip_smoke.FOUR_REPLICA_TOL, spread
