"""Physics parity vs the C++ oracle (BASELINE config 1 instantiation —
see parity/check_physics_parity.py for why the oracle stands in for the
reference: empty mount + no pymunk, SURVEY.md §0.1/§7.5).

Runs in a subprocess because the harness needs JAX_ENABLE_X64, which is
process-global and would contaminate the float32 tests here.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_physics_parity_vs_cpp_oracle():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "parity", "check_physics_parity.py")],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, (
        f"parity harness failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-2000:]}"
    )
    assert "FAIL" not in proc.stdout


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_env_step_parity_vs_cpp_oracle():
    """FULL env.step pipeline (actions/possession/kick/dribble/physics/
    goals/OOB/rewards/kickoff/auto-reset) vs the native oracle, with the
    jnp path's RNG draws injected into the oracle."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "parity", "check_env_parity.py")],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, (
        f"env parity harness failed\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr[-2000:]}"
    )
    assert "FAIL" not in proc.stdout
    # the harness must actually exercise goal / episode-end events
    assert "WARN" not in proc.stdout
