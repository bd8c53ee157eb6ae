"""Distributed tier of the port.

Counterpart of ``paddle_tpu/distributed``.  Ported so far: only
``launch.spawn_process``, the supervised-process spawner the serving
fleet (serving/fleet.py) uses.  The rest (the process launcher's watch
loop, collectives, the mesh, sharded training) waits for ROADMAP.md
queue 1 item 9.
"""
from .launch import spawn_process  # noqa

__all__ = ["spawn_process"]
