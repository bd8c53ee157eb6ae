"""Supervised-process spawning.

The port's counterpart of ``paddle_tpu/distributed/launch.py``, holding
only :func:`spawn_process` (``paddle_tpu/distributed/launch.py:38-63``):
the one helper the serving fleet supervisor (:mod:`paddle_tpu_torch.
serving.fleet`) spawns its replicas through, so restart accounting and
log capture live in one place.  The launcher itself (``python -m
paddle_tpu.distributed.launch``: one process per host, the coordinator
environment, the elastic watch loop) is not ported yet; it waits for
ROADMAP.md queue 1 item 9, the multi-card tier.
"""
from __future__ import annotations

import os
import subprocess

__all__ = ["spawn_process"]


def spawn_process(cmd, env_overrides=None, log_path=None,
                  restart_count=0):
    """Spawn one supervised worker process: current env + overrides,
    ``PADDLE_TPU_RESTART_COUNT`` accounting (which life this worker is
    on; 0 = first — a restarted worker can tell a fresh launch from a
    respawn), stdout+stderr appended to ``log_path`` when given."""
    env = dict(os.environ)
    env.update({k: str(v) for k, v in (env_overrides or {}).items()})
    env["PADDLE_TPU_RESTART_COUNT"] = str(restart_count)
    stdout = None
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        stdout = open(log_path, "a")
    try:
        return subprocess.Popen(cmd, env=env, stdout=stdout,
                                stderr=subprocess.STDOUT
                                if stdout else None)
    finally:
        if stdout is not None:
            stdout.close()  # the child holds its own descriptor
