"""Fleet supervisor: spawn, monitor, and roll N replica servers.

The port's counterpart of ``paddle_tpu/serving/fleet.py``, with the same
constructor, methods, counters and attribution.  Each child runs this
checkout's package: the supervisor puts the directory that holds
``paddle_tpu_torch`` first on the child's ``PYTHONPATH``, so a replica
never imports another copy.  A replica runs on the card unless its
argv carries ``--device cpu``.  Not ported: the ``embedding`` role
(the recsys tier, ROADMAP.md queue 1 item 8).

The process-management half of the fleet front end (the routing half
is :mod:`paddle_tpu_torch.serving.router`): each replica is one
``python -m paddle_tpu_torch.serving.replica`` subprocess spawned through
the launcher machinery (:func:`paddle_tpu_torch.distributed.launch.
spawn_process` — shared restart accounting + log capture), with its
own port, metrics dir, and ``PADDLE_TPU_REPLICA_ID`` env.

* **Stable URLs.** A replica's first life binds a free port the
  supervisor draws OUTSIDE the kernel's ephemeral range
  (``ip_local_port_range``; the JAX package's supervisor passes 0, an
  ephemeral port) and publishes it via an atomic endpoint file; the
  supervisor PINS that port for every respawn, so the router registry
  never changes across crashes or rollouts.  An ephemeral port is the
  pool every outgoing connection draws its source port from (the
  router's relays, load generators, probes): while the replica is
  down one of them can take it, and the respawns cannot bind until it
  is free again, ~60 s of TIME_WAIT after it closes.  A life that
  cannot bind logs the errno and the port (``BIND_ERROR``) and exits
  1; the supervisor names that error in the death record, the respawn
  log line and the ``fleet_replica_crash`` event, and draws a new port
  for a first life that never bound.

* **Crash detection → bounded respawn.** A monitor thread polls the
  processes; an unexpected exit respawns the replica with exponential
  backoff (``FLAGS_fleet_restart_backoff_ms`` doubling per
  consecutive crash, capped at 5s) up to ``FLAGS_fleet_max_restarts``
  times — past the budget the replica stays down and
  ``fleet_replicas_live`` drops.  Every life increments the
  ``PADDLE_TPU_RESTART_COUNT`` the replica sees (launch.py's elastic
  accounting), and a healthy start (ready reached) resets the crash
  streak.

* **Hung-replica liveness deadline.** Exit-code monitoring cannot see
  a *hung* replica — SIGSTOP'd or wedged, its PID stays alive while
  it silently holds forwards open.  A liveness thread polls each
  replica's ``/healthz``; once a life has answered at least once, a
  replica whose health then goes silent for
  ``FLAGS_fleet_liveness_timeout_ms`` while its PID is alive is
  **SIGKILLed** (``fleet_hung_kills``) and respawned through the
  normal crash path (backoff + restart budget — a replica that hangs
  repeatedly is as broken as one that crashes repeatedly).  The
  deadline arms only after the first successful health response of a
  life, so a successor paying its import/bind cost is never shot.
  A ``/profilez`` capture holds the replica's GIL through the
  profiler's stop and trace export: while the replica marks one
  (``observatory.capture_waiver_until``), the deadline counts from the
  end of its waiver, not from the last answer.

* **Drain-aware rolling restart.** :meth:`rolling_restart` takes the
  fleet through a rollout ONE replica at a time: SIGTERM (the
  replica's existing drain path serves out everything admitted),
  wait for the process to exit cleanly, respawn the successor at the
  same port, and wait until its ``/healthz`` reports ``ready`` (shape
  buckets primed) before touching the next replica — at every instant
  N-1 replicas are routable, which is what lets the router pass
  traffic through a rollout with zero non-shed failures (asserted by
  ``bench.py run_router`` and ``tests/test_router.py``).

* **In-place hot-swap rollout.** :meth:`hot_swap` rolls a new weights
  checkpoint through the fleet ONE replica at a time via ``POST
  /swap`` — no process restart, no recompile, the replica's queue
  rides through.  Each replica must report the new
  ``weights_version`` and ``ready`` on ``/healthz`` before the next
  is touched.  A replica that refuses the swap (409 structural
  mismatch, 503 wedged quiesce, a dead socket) falls back
  automatically to the restart path — SIGTERM drain, respawn at the
  same port, re-swap the fresh process — so a rollout converges even
  when a replica's live state has drifted.

* **Postmortem pipeline.** Every replica death is harvested for the
  flight-recorder artifacts its life left in
  ``<metrics_dir>/postmortem/`` (self-dumps, the rolling dump, the
  supervisor's own hung-kill mark — :mod:`paddle_tpu_torch.blackbox`) and
  **attributed**: ``clean_exit`` / ``hung_kill`` /
  ``signal:<NAME>`` (WTERMSIG decoded) / ``crash:<reason>`` /
  ``unexplained`` (died rc>0 with no self-dump — the count chaos
  hard-zeroes).  The attribution rides the respawn log/event, per-
  replica ``statusz()``, and the router's ``/fleetz``+``/debugz``
  via :meth:`attach_router`.

Stats (README catalog): counters ``fleet_restarts``,
``fleet_rolling_restarts``, ``fleet_hung_kills``, ``fleet_hot_swaps``,
``fleet_hot_swap_fallbacks``, ``fleet_postmortems_collected``,
``fleet_deaths_unexplained``; gauge ``fleet_replicas_live``.
"""
from __future__ import annotations

import json
import logging
import os
import random
import re
import signal
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from .. import blackbox, observatory, telemetry
from ..distributed.launch import spawn_process
from ..flags import flag_value, register_flag
from ..monitor import stat_add

__all__ = ["FleetSupervisor", "ephemeral_range", "pick_port", "bind_error"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")

_BACKOFF_CAP_S = 5.0
_MONITOR_POLL_S = 0.1
# where Linux keeps the ephemeral (local) port range; its default
_PORT_RANGE_FILE = "/proc/sys/net/ipv4/ip_local_port_range"
_DEFAULT_PORT_RANGE = (32768, 60999)
# the lowest port a first life is given (below it: well-known services)
_LOW_PORT = 10000
# the line a replica logs when its listener cannot bind (serving/replica.py)
BIND_ERROR = "replica bind failed"
_BIND_ERROR_RE = re.compile(BIND_ERROR + r": pid (\d+) port (\d+) errno "
                            r"(\d+) \((\w+)\)")
# how much of a log's end the supervisor reads for a dead life's line
_LOG_TAIL_BYTES = 16384
# the directory holding this checkout's paddle_tpu_torch package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

register_flag("FLAGS_fleet_liveness_timeout_ms", 5000.0,
              "fleet supervisor: a replica whose PID is alive but whose "
              "/healthz has not answered for this long after previously "
              "answering (SIGSTOP'd / wedged, invisible to exit-code "
              "monitoring) is SIGKILLed and respawned through the crash "
              "path (fleet_hung_kills); 0 disables the liveness "
              "watchdog")
register_flag("FLAGS_fleet_replicas", 2,
              "fleet supervisor: replica server processes to spawn "
              "(paddle_tpu_torch/serving/fleet.py; each gets its own "
              "port, metrics dir, and PADDLE_TPU_REPLICA_ID env)")
register_flag("FLAGS_fleet_max_restarts", 3,
              "fleet supervisor: respawn a CRASHED replica up to N "
              "times (exponential backoff, PADDLE_TPU_RESTART_COUNT "
              "accounting); past the budget the replica stays down and "
              "fleet_replicas_live drops.  Rolling-restart respawns "
              "are planned exits and do not count")
register_flag("FLAGS_fleet_restart_backoff_ms", 200.0,
              "fleet supervisor: base crash-respawn backoff; doubles "
              "per consecutive crash of the same replica (capped at "
              "5s), resets after a healthy start")


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def swap_timeout_s(checkpoint_dir: str) -> float:
    """The bound on one ``POST /swap`` of ``checkpoint_dir``: the
    replica reads ``__params__`` inside the request, so 35 s (the
    reference's bound) plus 4 s a GiB of the file (a read at 0.25
    GiB/s).  A 25.10 GiB Llama-2-7B checkpoint takes 15-24 s in one
    process on an H100 host and gets 135 s; a missing file gets 35 s
    (the replica refuses it at once)."""
    try:
        size = os.path.getsize(os.path.join(checkpoint_dir, "__params__"))
    except OSError:
        size = 0
    return 35.0 + 4.0 * size / 2 ** 30


def ephemeral_range() -> Tuple[int, int]:
    """The kernel's ephemeral port range (low, high): every outgoing
    connection that names no source port draws one from it."""
    try:
        with open(_PORT_RANGE_FILE, encoding="ascii") as f:
            lo, hi = (int(x) for x in f.read().split()[:2])
        return lo, hi
    except (OSError, ValueError):
        return _DEFAULT_PORT_RANGE


def pick_port(host: str = "127.0.0.1") -> int:
    """A port outside ``ephemeral_range`` that binds now, as a replica's
    listener binds (SO_REUSEADDR on), drawn at random so that supervisors
    side by side rarely draw the same one; 0 (ephemeral) where the range
    leaves no port or none of 64 draws binds."""
    lo, hi = ephemeral_range()
    spans = [(a, b) for a, b in ((_LOW_PORT, lo - 1), (hi + 1, 65535))
             if a <= b]
    total = sum(b - a + 1 for a, b in spans)
    rng = random.SystemRandom()
    for _ in range(64 if total else 0):
        k = rng.randrange(total)
        for a, b in spans:
            if k <= b - a:
                port = a + k
                break
            k -= b - a + 1
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind((host, port))
            except OSError:
                continue
        return port
    return 0


def bind_error(log_path: str, pid: int) -> Optional[dict]:
    """The bind error life `pid` logged before it exited (``BIND_ERROR``'s
    line in the end of its log): {"port", "errno", "name"}, or None."""
    try:
        with open(log_path, "rb") as f:
            f.seek(max(0, os.path.getsize(log_path) - _LOG_TAIL_BYTES))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return None
    found = None
    for m in _BIND_ERROR_RE.finditer(tail):
        if int(m.group(1)) == pid:
            found = {"port": int(m.group(2)), "errno": int(m.group(3)),
                     "name": m.group(4)}
    return found


def _healthz(url: str, timeout: float = 2.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=timeout) as r:
            return json.loads(r.read())
    except (OSError, TimeoutError, ValueError):
        return None


class _Replica:
    """Supervisor-side state for one replica slot."""

    def __init__(self, idx: int, rdir: str, role: Optional[str] = None):
        self.idx = idx
        self.dir = rdir
        self.role = role      # disagg role argv (None = supervisor-wide)
        self.endpoint_file = os.path.join(rdir, "endpoint.json")
        self.log_path = os.path.join(rdir, "replica.log")
        self.metrics_dir = os.path.join(rdir, "metrics")
        self.proc = None
        self.port: Optional[int] = None     # pinned after first bind
        # the port a first life is given, drawn outside the ephemeral
        # range (pick_port), until a life has bound
        self.first_port: Optional[int] = None
        self.url: Optional[str] = None
        self.lives = 0            # spawns so far (-> RESTART_COUNT)
        self.crash_streak = 0     # consecutive crashes (backoff input)
        self.crash_restarts = 0   # crash respawns consumed of budget
        self.failed = False       # past the restart budget: stays down
        self.in_rollout = False   # monitor keeps hands off
        self.respawn_at: Optional[float] = None  # backoff deadline
        # liveness watchdog: monotonic ts of this LIFE's last good
        # /healthz answer; None until the life answers once (the
        # deadline must not fire on a successor still importing)
        self.last_alive: Optional[float] = None
        self.hung_kills = 0       # liveness SIGKILLs on this slot
        # crash forensics: the most recent death's attribution record
        # and the slot's running artifact/unexplained tallies
        self.last_death: Optional[dict] = None
        self.postmortems = 0      # artifacts harvested across deaths
        self.unexplained = 0      # deaths with no explanation


class FleetSupervisor:
    """Spawn and babysit ``replicas`` replica server processes.

    ``replica_argv`` — extra CLI args for every
    ``paddle_tpu_torch.serving.replica`` process (model sizing /
    ``--model-dir`` etc.); ``env`` — extra env vars for every replica
    (e.g. serving ``FLAGS_*``).  ``workdir`` (default: a fresh temp
    dir) holds per-replica ``replica-<i>/`` dirs: endpoint file, log,
    metrics dir."""

    def __init__(self, replicas: Optional[int] = None,
                 replica_argv: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 workdir: Optional[str] = None,
                 max_restarts: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 liveness_timeout_ms: Optional[float] = None,
                 roles: Optional[List[str]] = None,
                 autostart: bool = True):
        self.n = int(replicas if replicas is not None
                     else (len(roles) if roles is not None
                           else flag_value("FLAGS_fleet_replicas")))
        if self.n < 1:
            raise ValueError("FleetSupervisor needs >= 1 replica")
        # role-aware fleet: one disagg role per replica slot
        # (prefill|decode|both), appended to its argv as --role and
        # PINNED across respawns like the port — a crashed prefill
        # replica's successor is a prefill replica
        if roles is not None:
            if len(roles) != self.n:
                raise ValueError(f"roles has {len(roles)} entries for "
                                 f"{self.n} replicas")
            if "embedding" in roles:
                raise NotImplementedError(
                    "the embedding role (the recsys tier) is not ported "
                    "yet: ROADMAP.md queue 1 item 8")
            bad = [r for r in roles
                   if r not in ("both", "prefill", "decode")]
            if bad:
                raise ValueError(f"unknown role(s) {bad}; want "
                                 f"both|prefill|decode")
        self.roles = list(roles) if roles is not None else None
        self.replica_argv = list(replica_argv or [])
        self.env = dict(env or {})
        self.workdir = workdir or tempfile.mkdtemp(prefix="fleet-")
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else flag_value("FLAGS_fleet_max_restarts"))
        self._backoff_s = float(
            backoff_ms if backoff_ms is not None
            else flag_value("FLAGS_fleet_restart_backoff_ms")) / 1e3
        self._liveness_s = float(
            liveness_timeout_ms if liveness_timeout_ms is not None
            else flag_value("FLAGS_fleet_liveness_timeout_ms")) / 1e3
        self._lock = threading.Lock()
        self._replicas = [
            _Replica(i, os.path.join(self.workdir, f"replica-{i}"),
                     role=self.roles[i] if self.roles else None)
            for i in range(self.n)]
        # an Event, not a lock-guarded bool: the monitor/liveness loop
        # headers poll it every cycle, and an Event read is race-free
        # WITHOUT contending the supervisor lock (which rolling
        # restarts hold across whole replica drains)
        self._closing = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._liveness: Optional[threading.Thread] = None
        self._started = time.time()
        if autostart:
            self.start()

    # -- spawning -----------------------------------------------------------
    def _spawn(self, rep: _Replica):
        os.makedirs(rep.dir, exist_ok=True)
        # stale endpoint files must not satisfy the bind-wait below
        try:
            os.remove(rep.endpoint_file)
        except FileNotFoundError:
            pass  # ok: first spawn
        if rep.port is None and rep.first_port is None:
            rep.first_port = pick_port()
        cmd = [sys.executable, "-u", "-m", "paddle_tpu_torch.serving.replica",
               "--endpoint-file", rep.endpoint_file,
               "--port", str(rep.port or rep.first_port or 0),
               *self.replica_argv]
        if rep.role is not None:
            cmd += ["--role", rep.role]
        env = dict(self.env)
        path = env.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        env.update({
            "PADDLE_TPU_REPLICA_ID": str(rep.idx),
            "FLAGS_metrics_dir": rep.metrics_dir,
            # this checkout first: the child imports this package
            "PYTHONPATH": os.pathsep.join(
                [_CHECKOUT] + [p for p in path.split(os.pathsep) if p]),
        })
        rep.proc = spawn_process(cmd, env, rep.log_path,
                                 restart_count=rep.lives)
        rep.lives += 1
        rep.respawn_at = None
        rep.last_alive = None  # liveness re-arms on this life's first
        # successful health answer
        logger.info("replica %d spawned (pid %d, life %d, port %s)",
                    rep.idx, rep.proc.pid, rep.lives,
                    rep.port or rep.first_port or "ephemeral")
        self._publish_live()

    def start(self):
        for rep in self._replicas:
            if rep.proc is None:
                self._spawn(rep)
        if self._monitor is None:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             name="fleet-monitor",
                                             daemon=True)
            self._monitor.start()
        if self._liveness is None and self._liveness_s > 0:
            self._liveness = threading.Thread(
                target=self._liveness_loop, name="fleet-liveness",
                daemon=True)
            self._liveness.start()

    def _publish_live(self):
        live = sum(1 for r in self._replicas
                   if r.proc is not None and r.proc.poll() is None)
        telemetry.gauge_set("fleet_replicas_live", live)

    # -- readiness ----------------------------------------------------------
    def _wait_bound(self, rep: _Replica, deadline: float) -> bool:
        """Wait for the endpoint file of rep's CURRENT life."""
        while time.monotonic() < deadline:
            doc = _read_json(rep.endpoint_file)
            if doc and doc.get("pid") == rep.proc.pid:
                rep.port = int(doc["port"])
                rep.url = doc["url"]
                return True
            if rep.proc.poll() is not None:
                return False
            time.sleep(0.05)
        return False

    def _wait_replica_ready(self, rep: _Replica,
                            deadline: float) -> bool:
        if not self._wait_bound(rep, deadline):
            return False
        while time.monotonic() < deadline:
            h = _healthz(rep.url)
            if h is not None and h.get("ready"):
                rep.crash_streak = 0  # healthy start resets backoff
                return True
            if rep.proc.poll() is not None:
                return False
            time.sleep(0.05)
        return False

    def wait_ready(self, timeout_s: float = 120.0) -> List[str]:
        """Block until every replica is bound, warmed, and reporting
        ``ready``; returns the (stable) base URLs.  Raises on timeout
        or a replica that died before readiness."""
        deadline = time.monotonic() + timeout_s
        for rep in self._replicas:
            if not self._wait_replica_ready(rep, deadline):
                rc = rep.proc.poll() if rep.proc is not None else None
                tail = ""
                try:
                    with open(rep.log_path, encoding="utf-8",
                              errors="replace") as f:
                        tail = f.read()[-2000:]
                except OSError as e:
                    tail = f"<log unreadable: {e}>"
                raise RuntimeError(
                    f"replica {rep.idx} not ready in {timeout_s}s "
                    f"(rc={rc}); log tail:\n{tail}")
        return self.endpoints()

    def endpoints(self) -> List[str]:
        return [r.url for r in self._replicas if r.url]

    # -- crash monitor ------------------------------------------------------
    def _monitor_loop(self):
        while not self._closing.is_set():
            time.sleep(_MONITOR_POLL_S)
            with self._lock:
                if self._closing.is_set():
                    return
                for rep in self._replicas:
                    self._check_one(rep)

    def _book_death(self, rep: _Replica, rc: Optional[int]) -> dict:
        """Harvest + attribute one replica death (the postmortem
        pipeline): collect whatever the dead life left in its
        ``postmortem/`` dir, classify the death, book the counters,
        and remember the record on the slot.  Called with the
        supervisor lock held; the work is a directory listing."""
        pid = rep.proc.pid if rep.proc is not None else None
        arts = blackbox.harvest(rep.metrics_dir, pid) \
            if pid is not None else []
        attribution = blackbox.attribute_death(rc, arts)
        bind = bind_error(rep.log_path, pid) if pid is not None else None
        rec = {"pid": pid, "rc": rc,
               "signal": blackbox.signal_name(rc),
               "attribution": attribution,
               "postmortems": [a["path"] for a in arts],
               "bind_error": bind,
               "time": round(time.time(), 3)}
        if bind is not None and rep.port is None:
            # a first life that never bound: the next one draws anew
            rep.first_port = None
        rep.last_death = rec
        if arts:
            rep.postmortems += len(arts)
            stat_add("fleet_postmortems_collected")
        if attribution == "unexplained":
            rep.unexplained += 1
            stat_add("fleet_deaths_unexplained")
        return rec

    @staticmethod
    def _rc_str(rc: Optional[int]) -> str:
        """``-9 (SIGKILL)`` instead of a bare ``-9`` — every log line
        that reports a death names the signal (WTERMSIG decoded)."""
        sig = blackbox.signal_name(rc)
        return f"{rc} ({sig})" if sig else str(rc)

    def _check_one(self, rep: _Replica):
        if rep.in_rollout or rep.failed or rep.proc is None:
            return
        if rep.respawn_at is not None:
            # in crash backoff: respawn once the deadline passes
            if time.monotonic() >= rep.respawn_at:
                self._spawn(rep)
            return
        rc = rep.proc.poll()
        if rc is None:
            return
        # unexpected exit = crash (planned exits happen only inside
        # rolling_restart / close, which hold the rollout flag or
        # _closing)
        self._publish_live()
        death = self._book_death(rep, rc)
        if rep.crash_restarts >= self.max_restarts:
            rep.failed = True
            logger.error("replica %d exited rc=%s past the restart "
                         "budget (%d); staying down [%s]", rep.idx,
                         self._rc_str(rc), self.max_restarts,
                         death["attribution"])
            telemetry.log_event("fleet_replica_failed", replica=rep.idx,
                                rc=rc, signal=death["signal"],
                                attribution=death["attribution"],
                                postmortems=len(death["postmortems"]))
            return
        rep.crash_restarts += 1
        rep.crash_streak += 1
        backoff = min(self._backoff_s * (2 ** (rep.crash_streak - 1)),
                      _BACKOFF_CAP_S)
        rep.respawn_at = time.monotonic() + backoff
        stat_add("fleet_restarts")
        bind = death["bind_error"]
        logger.warning("replica %d crashed rc=%s [%s, %d postmortem(s)%s]"
                       "; respawn %d/%d in %.2fs", rep.idx,
                       self._rc_str(rc), death["attribution"],
                       len(death["postmortems"]),
                       "" if bind is None else
                       f", cannot bind port {bind['port']}: errno "
                       f"{bind['errno']} ({bind['name']})",
                       rep.crash_restarts, self.max_restarts, backoff)
        telemetry.log_event("fleet_replica_crash", replica=rep.idx,
                            rc=rc, signal=death["signal"],
                            attribution=death["attribution"],
                            postmortems=len(death["postmortems"]),
                            bind_error=bind,
                            restart=rep.crash_restarts,
                            backoff_s=round(backoff, 3))

    # -- hung-replica liveness watchdog -------------------------------------
    def _liveness_loop(self):
        """Health-poll every replica off the monitor's lock; a PID
        that is alive but whose health went silent past the liveness
        deadline (after answering at least once this life) gets
        SIGKILL — the crash monitor then respawns it with the normal
        backoff/budget accounting."""
        interval = max(0.2, self._liveness_s / 4.0)
        while not self._closing.is_set():
            time.sleep(interval)
            if self._closing.is_set():
                return
            for rep in self._replicas:
                with self._lock:
                    skip = (self._closing.is_set() or rep.in_rollout
                            or rep.failed or rep.proc is None
                            or rep.respawn_at is not None
                            or rep.url is None
                            or rep.proc.poll() is not None)
                    url = rep.url
                    proc = rep.proc
                if skip:
                    continue
                # the HTTP round-trip happens OUTSIDE the lock: a
                # blackholed replica must not stall the crash monitor
                h = _healthz(url, timeout=min(1.0, interval))
                now = time.monotonic()
                # a /profilez capture's stop and export hold the
                # replica's GIL: its mark moves the deadline's start
                until = None if h is not None else \
                    observatory.capture_waiver_until(rep.metrics_dir,
                                                     proc.pid)
                with self._lock:
                    if (self._closing.is_set() or rep.in_rollout
                            or rep.proc is not proc
                            or proc.poll() is not None):
                        # the life this poll measured is gone (crash
                        # respawn raced us): its answer must neither
                        # arm nor trip the NEW life's deadline
                        continue
                    if h is not None:
                        rep.last_alive = now
                        continue
                    since = rep.last_alive
                    if since is not None and until is not None:
                        since = max(since, now + until - time.time())
                    hung = (since is not None
                            and now - since > self._liveness_s)
                    if not hung:
                        continue
                    stale_s = now - rep.last_alive
                    rep.hung_kills += 1
                stat_add("fleet_hung_kills")
                logger.warning(
                    "replica %d pid %d alive but health silent for "
                    "%.1fs (> %.1fs liveness deadline); SIGKILL + "
                    "respawn", rep.idx, proc.pid, stale_s,
                    self._liveness_s)
                telemetry.log_event("fleet_replica_hung",
                                    replica=rep.idx,
                                    pid=proc.pid,
                                    stale_s=round(stale_s, 3))
                # the kill mark goes down BEFORE the bullet: a
                # SIGSTOP'd/wedged process cannot dump its own flight
                # recorder, so the supervisor leaves the evidence the
                # crash monitor will harvest (attribution hung_kill)
                blackbox.write_kill_mark(
                    rep.metrics_dir, proc.pid, replica=rep.idx,
                    stale_s=round(stale_s, 3),
                    liveness_timeout_s=self._liveness_s)
                try:
                    # the verified life's handle — a respawn racing in
                    # after the lock released must not catch the bullet
                    proc.kill()  # SIGKILL works on a stopped PID
                except OSError as e:
                    logger.warning("hung-kill of replica %d failed: "
                                   "%s", rep.idx, e)

    # -- rollout ------------------------------------------------------------
    def rolling_restart(self, ready_timeout_s: float = 120.0,
                        drain_timeout_s: float = 30.0) -> dict:
        """Drain-aware rollout: one replica at a time, SIGTERM → wait
        for its drain path to flush and the process to exit → respawn
        at the same port → wait for the successor's ``ready`` — then
        the next replica.  The fleet never has more than one replica
        out at a time, so a router keeps serving throughout (the
        zero-non-shed-failure window asserted by the bench leg and the
        test matrix).  Returns per-replica timings."""
        stat_add("fleet_rolling_restarts")
        t0 = time.monotonic()
        out = []
        for rep in self._replicas:
            if rep.failed or rep.proc is None:
                out.append({"replica": rep.idx, "skipped": "down"})
                continue
            with self._lock:
                rep.in_rollout = True
            try:
                t_rep = time.monotonic()
                rep.proc.send_signal(signal.SIGTERM)
                try:
                    rc = rep.proc.wait(drain_timeout_s)
                except Exception:  # subprocess.TimeoutExpired
                    logger.warning("replica %d did not drain in %.1fs; "
                                   "killing", rep.idx, drain_timeout_s)
                    rep.proc.kill()
                    rc = rep.proc.wait(5.0)
                drain_s = time.monotonic() - t_rep
                with self._lock:
                    # every death is booked, planned ones included: a
                    # drain that actually died by signal (or left a
                    # self-dump) must not hide inside a rollout
                    death = self._book_death(rep, rc)
                if death["attribution"] != "clean_exit":
                    logger.warning(
                        "replica %d rollout exit rc=%s [%s]", rep.idx,
                        self._rc_str(rc), death["attribution"])
                self._spawn(rep)
                ok = self._wait_replica_ready(
                    rep, time.monotonic() + ready_timeout_s)
                out.append({"replica": rep.idx, "exit_rc": rc,
                            "drain_s": round(drain_s, 3),
                            "successor_ready": ok,
                            "total_s": round(
                                time.monotonic() - t_rep, 3)})
                if not ok:
                    raise RuntimeError(
                        f"rolling restart: replica {rep.idx} successor "
                        f"never became ready")
            finally:
                with self._lock:
                    rep.in_rollout = False
        telemetry.log_event("fleet_rolling_restart",
                            replicas=len(out),
                            duration_s=round(time.monotonic() - t0, 3))
        return {"replicas": out,
                "duration_s": round(time.monotonic() - t0, 3)}

    @staticmethod
    def _post_swap(url: str, body: dict, timeout_s: float = 35.0):
        """POST /swap to one replica; returns ``(status, payload)``
        with the payload parsed for error codes too (409/503 carry
        the refusal detail), or ``(None, {...})`` when the socket
        itself failed."""
        req = urllib.request.Request(
            url.rstrip("/") + "/swap", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except ValueError:
                return e.code, {}
        except (OSError, TimeoutError, ValueError) as e:
            return None, {"error": f"{type(e).__name__}: {e}"}

    def _verify_swapped(self, rep: _Replica, version,
                        deadline: float, target: str = "predict") -> bool:
        """The per-replica rollout gate: ``/healthz`` must report
        ``ready`` AND the expected ``weights_version`` before the
        next replica is touched — a swap that 200'd but never became
        visible is a failed swap.  The version read is the swapped
        engine's: top-level for ``"predict"``, the ``generation``
        block's for ``"generate"`` (the generation engine counts its
        own versions)."""
        while time.monotonic() < deadline:
            h = _healthz(rep.url)
            seen = None
            if h is not None:
                seen = (h.get("generation") or {}).get("weights_version") \
                    if target == "generate" else h.get("weights_version")
            if (h is not None and h.get("ready")
                    and (version is None or seen == version)):
                return True
            if rep.proc.poll() is not None:
                return False
            time.sleep(0.05)
        return False

    def hot_swap(self, checkpoint_dir: str,
                 ready_timeout_s: float = 120.0,
                 drain_timeout_s: float = 30.0,
                 target: str = "predict") -> dict:
        """Roll ``checkpoint_dir`` through the fleet in place: ``POST
        /swap`` one replica at a time, each verified (new
        ``weights_version`` visible on ``/healthz`` + ``ready``)
        before the next — milliseconds per replica, zero respawns,
        zero recompiles, the replica's queued requests ride through.

        A replica that refuses (409 mismatch / 503 quiesce timeout /
        dead socket) or whose new version never becomes visible falls
        back to the restart path automatically: SIGTERM drain →
        respawn at the same port → wait ready → re-swap the fresh
        process (``fleet_hot_swap_fallbacks``).  Per-replica outcomes
        are returned, ``converged`` only when every live replica ended
        on the new weights.  Each ``POST /swap`` is bounded by
        :func:`swap_timeout_s` of the checkpoint (the replica reads it
        inside the request)."""
        stat_add("fleet_hot_swaps")
        t0 = time.monotonic()
        body = {"dir": checkpoint_dir, "target": target}
        swap_timeout = swap_timeout_s(checkpoint_dir)
        out = []
        converged = True
        for rep in self._replicas:
            if rep.failed or rep.proc is None or rep.url is None:
                out.append({"replica": rep.idx, "skipped": "down"})
                continue
            with self._lock:
                rep.in_rollout = True
            try:
                t_rep = time.monotonic()
                code, payload = self._post_swap(rep.url, body,
                                                swap_timeout)
                entry = {"replica": rep.idx, "swap_status": code}
                ok = False
                if code == 200:
                    ok = self._verify_swapped(
                        rep, payload.get("weights_version"),
                        time.monotonic() + ready_timeout_s, target)
                    entry["swap_ms"] = payload.get("swap_ms")
                    entry["weights_version"] = \
                        payload.get("weights_version")
                if not ok:
                    entry["rejected"] = payload.get("error") \
                        or payload.get("detail") or "verify failed"
                    ok = self._swap_fallback_restart(
                        rep, body, entry, ready_timeout_s,
                        drain_timeout_s, swap_timeout)
                entry["ok"] = ok
                entry["total_s"] = round(time.monotonic() - t_rep, 3)
                out.append(entry)
                converged = converged and ok
            finally:
                with self._lock:
                    rep.in_rollout = False
        dur = round(time.monotonic() - t0, 3)
        telemetry.log_event("fleet_hot_swap", replicas=len(out),
                            converged=converged, duration_s=dur)
        return {"replicas": out, "converged": converged,
                "duration_s": dur}

    def _swap_fallback_restart(self, rep: _Replica, body: dict,
                               entry: dict, ready_timeout_s: float,
                               drain_timeout_s: float,
                               swap_timeout: float) -> bool:
        """The rollout's safety net: a replica that cannot swap in
        place is drained, respawned at its pinned port, and the FRESH
        process swapped — same net effect (new weights at the same
        URL), restart cost instead of milliseconds."""
        stat_add("fleet_hot_swap_fallbacks")
        logger.warning("replica %d refused the hot swap (%s); falling "
                       "back to restart", rep.idx,
                       entry.get("rejected"))
        if rep.proc.poll() is None:
            rep.proc.send_signal(signal.SIGTERM)
        try:
            rc = rep.proc.wait(drain_timeout_s)
        except Exception:  # subprocess.TimeoutExpired
            logger.warning("replica %d did not drain in %.1fs; killing",
                           rep.idx, drain_timeout_s)
            rep.proc.kill()
            rc = rep.proc.wait(5.0)
        with self._lock:
            # a replica that DIED mid-swap (vs refusing it) reaches
            # this path with the monitor's hands off (in_rollout):
            # its death is booked here so the postmortem pipeline
            # sees every death, rollout or not
            death = self._book_death(rep, rc)
        entry["death"] = {"rc": rc, "signal": death["signal"],
                          "attribution": death["attribution"]}
        self._spawn(rep)
        if not self._wait_replica_ready(
                rep, time.monotonic() + ready_timeout_s):
            entry["fallback"] = "successor never ready"
            return False
        code, payload = self._post_swap(rep.url, body, swap_timeout)
        entry["fallback"] = {"swap_status": code,
                             "weights_version":
                                 payload.get("weights_version")}
        if code != 200:
            entry["fallback"]["rejected"] = payload.get("error") \
                or payload.get("detail")
            return False
        return self._verify_swapped(
            rep, payload.get("weights_version"),
            time.monotonic() + ready_timeout_s, body.get("target",
                                                         "predict"))

    # -- introspection / teardown -------------------------------------------
    def statusz(self) -> dict:
        with self._lock:
            reps = [{
                "replica": r.idx, "url": r.url, "port": r.port,
                "role": r.role,
                "pid": r.proc.pid if r.proc is not None else None,
                "alive": r.proc is not None and r.proc.poll() is None,
                "lives": r.lives, "crash_restarts": r.crash_restarts,
                "hung_kills": r.hung_kills,
                "failed": r.failed, "in_rollout": r.in_rollout,
                "last_death": r.last_death,
                "postmortems_collected": r.postmortems,
                "unexplained_deaths": r.unexplained,
            } for r in self._replicas]
        return {"replicas": reps, "max_restarts": self.max_restarts,
                "workdir": self.workdir,
                "uptime_s": round(time.time() - self._started, 3)}

    def forensics(self) -> dict:
        """The crash-forensics summary ``/fleetz`` carries when this
        supervisor is attached to a router: per-replica latest death
        attribution plus the fleet-wide artifact/unexplained
        tallies."""
        with self._lock:
            deaths = [dict(r.last_death, replica=r.idx)
                      for r in self._replicas
                      if r.last_death is not None]
            collected = sum(r.postmortems for r in self._replicas)
            unexplained = sum(r.unexplained for r in self._replicas)
        return {"deaths": deaths,
                "postmortems_collected": collected,
                "unexplained_deaths": unexplained}

    def attach_router(self, router):
        """Surface this supervisor's death attributions on the
        router's ``/fleetz`` (``supervision`` block) and federated
        ``/debugz`` — the co-located-fleet wiring (one process runs
        both tiers; nothing crosses the network)."""
        router.supervisor = self
        return router

    def close(self, timeout_s: float = 30.0):
        with self._lock:
            if self._closing.is_set():
                return
            self._closing.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        if self._liveness is not None:
            self._liveness.join(timeout=5.0)
        for rep in self._replicas:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout_s
        for rep in self._replicas:
            if rep.proc is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                rep.proc.wait(left)
            except Exception:  # subprocess.TimeoutExpired
                logger.warning("replica %d ignored SIGTERM; killing",
                               rep.idx)
                rep.proc.kill()
                rep.proc.wait(5.0)
        self._publish_live()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
