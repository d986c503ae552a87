"""Multi-process (2 hosts x 4 virtual CPU devices) execution of the
distributed tier: exercises `parallel/multihost.py` (initialize_multihost,
host-major pod_mesh, process_local_rows) across a REAL process boundary —
the code paths a multi-host cluster hits first.  The workers run on the
CPU backend only.  NOT PRESENT in the reference
(single node); demanded by the north-star scaling tier (SURVEY.md §5)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_join():
    port = _free_port()
    env = dict(os.environ)
    # the workers force JAX_PLATFORMS=cpu themselves; scrub any pytest-level
    # XLA_FLAGS so the 4-device-per-process split is theirs alone
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"MHOK process={pid} ndev=8" in out, out[-3000:]
    # both processes agree on the (replicated) global count
    counts = {line.split("count=")[1] for out in outs
              for line in out.splitlines() if "MHOK" in line}
    assert len(counts) == 1, counts
