"""bench.py: refuses what it cannot run instead of timing something else,
and every record names the device and implementation."""

import json

import pytest

import bench
from gym_futbol_tpu.utils import device

DEVICE_FIELDS = ("platform", "device_kind", "device_count", "impl")
TINY = ["--envs", "16", "--steps", "2", "--iters", "1"]


@pytest.fixture
def reported_gpu(monkeypatch):
    """JAX's device record as bench.py reads it, reporting a GPU (the jnp
    path then runs on the CPU devices underneath)."""
    fake = {"platform": "gpu", "device_kind": "test GPU", "device_count": 8}
    monkeypatch.setattr(device, "device_record", lambda: dict(fake))
    return fake


def test_refuses_cpu_without_rehearsal_flag(capsys):
    with pytest.raises(SystemExit, match="times the GPU; JAX found cpu"):
        bench.main(["--config", "3", "--impl", "jnp", *TINY])
    assert "env_steps_per_sec" not in capsys.readouterr().out


@pytest.mark.parametrize("config", [2, 3])
def test_triton_refused_without_gpu(config, capsys):
    with pytest.raises(SystemExit, match="times the GPU"):
        bench.main(["--config", str(config), "--impl", "triton", *TINY])
    assert "env_steps_per_sec" not in capsys.readouterr().out


@pytest.mark.parametrize("config", [4, 5, 6])
def test_triton_refused_for_jnp_only_configs(config, reported_gpu, capsys):
    with pytest.raises(SystemExit, match="only the jnp"):
        bench.main(["--config", str(config), "--impl", "triton", *TINY])
    assert "env_steps_per_sec" not in capsys.readouterr().out


def test_record_names_device_and_impl(reported_gpu, capsys):
    record = bench.main(["--config", "3", "--impl", "jnp", *TINY])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(record))
    for k in DEVICE_FIELDS:
        assert k in record, k
    assert {k: record[k] for k in reported_gpu} == reported_gpu
    assert record["impl"] == "jnp" and record["value"] > 0
    assert "vs_baseline" not in record


def test_default_impl_per_config():
    assert bench.ROLLOUT_CONFIGS == (2, 3)
    bench.check_impl(3, "triton")    # the kernel path
    bench.check_impl(5, "jnp")
