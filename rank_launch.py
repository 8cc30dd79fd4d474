"""Start a command as several ranks on one host, for the port's
multi-process tests and `chip_smoke.py`'s two-rank phase (users start
ranks with torchrun), with torchrun's environment (RANK, LOCAL_RANK,
WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), so that each
process joins through `ofa_sr_tpu_torch.parallel.init_distributed()` with
no arguments. Unlike torchrun it bounds the whole run in time: when a
rank fails or the deadline passes, every rank still running is killed, so
a lost peer ends the run instead of leaving the others waiting in a
collective.

    outputs = launch([sys.executable, "worker.py"], nproc=2, timeout=120)
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, nproc, *, timeout, env=None, cwd=None, port=None):
    """Run `argv` as `nproc` ranks and wait for all of them; returns each
    rank's output (stdout and stderr together). Raises RuntimeError, with
    the tail of every rank's output, when a rank exits non-zero or the run
    outlasts `timeout` seconds; no rank is left running."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port or free_port()),
                WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc))
    logs = [tempfile.TemporaryFile() for _ in range(nproc)]
    procs = []
    try:
        for r in range(nproc):
            procs.append(subprocess.Popen(
                argv, cwd=cwd, stdout=logs[r], stderr=subprocess.STDOUT,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = "timed out after %.0f s" % timeout
            elif any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
            else:
                time.sleep(0.05)
        if failed is None and any(p.returncode for p in procs):
            failed = "a rank failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for f in logs:
        f.seek(0)
        outputs.append(f.read().decode(errors="replace"))
        f.close()
    if failed is not None:
        raise RuntimeError("%s (return codes %s):\n%s" % (
            failed, [p.returncode for p in procs],
            "\n".join("--- rank %d ---\n%s" % (r, out[-3000:])
                      for r, out in enumerate(outputs))))
    return outputs
