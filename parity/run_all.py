"""Run every parity/consistency gate and emit one JSON line.

    CPU gates   (JAX_PLATFORMS=cpu, float64; each in its own process, run
                 concurrently — they never touch a GPU):
      - check_env_parity      full env.step vs the C++ oracle (~1e-13)
      - check_physics_parity  physics substep vs the oracle
    device lane (the default JAX platform, a GPU; skipped with
                 --cpu-only). Its gates run ONE AT A TIME: a JAX process
                 reserves most of a card's memory when it starts, so two
                 device processes on one card would starve each other.
      - chip_smoke            env parity on the card, the fused Triton
                              rollout vs the jnp path, training, matmul
                              precision
      - check_learning        trained-vs-random win gate (opt-in:
                              --with-learning)

Prints one summary JSON object on the last line and exits nonzero if any
gate fails. Usage:

    python parity/run_all.py [--cpu-only] [--with-learning]
                             [--learning-ppt P] [--timeout SECONDS]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

CPU_GATES = ["check_env_parity.py", "check_physics_parity.py"]


def run_gate(path: str, cpu: bool, timeout: int,
             extra_args: list[str] | None = None) -> dict:
    env = dict(os.environ)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, path, *(extra_args or [])], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=timeout,
        )
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired:
        rc, out, err = 124, "", "timeout"
    tail = ((out or "").strip().splitlines() or [""])[-1]
    if rc != 0 and err:
        tail = err.strip().splitlines()[-1]
    rec = {
        "gate": os.path.basename(path).removesuffix(".py"),
        "ok": rc == 0,
        "seconds": round(time.perf_counter() - t0, 1),
        "last_line": tail[:200],
    }
    print(f"# {'OK ' if rec['ok'] else 'FAIL'} {rec['gate']:24s} "
          f"{rec['seconds']:7.1f}s  {rec['last_line']}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-only", action="store_true",
                    help="skip the device lane")
    ap.add_argument("--with-learning", action="store_true",
                    help="also run check_learning.py in the device lane")
    ap.add_argument("--learning-ppt", type=int, default=2,
                    help="team size for the learning gate (2/3/5; 3 and "
                         "5 run at the bench config-4/5 scales)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-gate timeout in seconds")
    args = ap.parse_args()

    t_start = time.perf_counter()
    device_gates = [(os.path.join(REPO, "chip_smoke.py"), None)]
    if args.with_learning:
        device_gates.append((os.path.join(HERE, "check_learning.py"),
                             ["--ppt", str(args.learning_ppt)]))

    def device_lane() -> list[dict]:
        return [run_gate(p, cpu=False, timeout=args.timeout, extra_args=a)
                for p, a in device_gates]

    results: list[dict] = []
    with ThreadPoolExecutor(max_workers=len(CPU_GATES) + 1) as ex:
        cpu_futs = [ex.submit(run_gate, os.path.join(HERE, s), True,
                              args.timeout) for s in CPU_GATES]
        dev_fut = None if args.cpu_only else ex.submit(device_lane)
        results += [f.result() for f in cpu_futs]
        if dev_fut is not None:
            results += dev_fut.result()

    skipped = []
    if args.cpu_only:
        skipped.append("device lane (--cpu-only)")
    elif not args.with_learning:
        skipped.append("check_learning (add --with-learning)")
    for s in skipped:
        print(f"# SKIPPED (not run, not certified): {s}", flush=True)

    ok = all(r["ok"] for r in results)
    print(json.dumps({
        "metric": "parity_gates_passed",
        "value": sum(r["ok"] for r in results),
        "unit": f"of {len(results)}",
        "ok": ok,
        "gates": {r["gate"]: r["ok"] for r in results},
        "skipped": skipped,
        "wall_seconds": round(time.perf_counter() - t_start, 1),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
