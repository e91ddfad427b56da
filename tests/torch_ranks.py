"""Rank processes for the port's multi-process tests, without JAX (the
ranks run torch autograd, which must not share a process with XLA:CPU).

Every rank joins its process group with a timeout of PG_TIMEOUT_S and runs
under a subprocess timeout of CHILD_TIMEOUT_S: a rank that dies leaves its
peers blocked in a collective only until then, and a rank's nonzero exit or
timeout fails the test.
"""

import os
import socket
import subprocess
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PG_TIMEOUT_S = 120
CHILD_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(argvs, envs):
    """Start one process per argv (with its env) and wait for all; fail on
    any nonzero exit or timeout, with every process's output."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    procs = [subprocess.Popen(argv, cwd=REPO, env=environ, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, environ in zip(argvs, envs)]
    outputs, failed = [], False
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
            failed = True
        outputs.append(out)
        failed |= proc.returncode != 0
    if failed:
        pytest.fail(f"ranks failed (exit codes {[p.returncode for p in procs]}):\n"
                    + "\n".join(f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outputs)))
    return outputs


def env(**extra):
    """The environment of a rank: the repository importable, one OpenMP
    thread, and ``extra``."""
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **extra}
