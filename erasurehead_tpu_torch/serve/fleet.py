"""Serve fleet: N replicated daemons, one router, zero-downtime deploys.

The port of erasurehead_tpu/serve/fleet.py. The single daemon (serve/server.py) already survives restarts — the
intake WAL replays its accepted working set. This module makes it
survive DEATH and upgrades without a maintenance window:

  - :class:`FleetSupervisor` spawns N ``python -m
    erasurehead_tpu_torch.cli serve`` replicas as same-host process groups
    (stdlib only: ``subprocess`` + the HTTP front each replica already
    has), each with its own journal directory + intake WAL, fronted by one
    :class:`FleetRouter` (serve/router.py) that consistent-hashes
    submissions by (tenant, cohort_signature) so packable work keeps
    landing where its device data stacks are hot. Every replica runs on
    the device the supervisor is given (``device=``, the card unless
    ``"cpu"`` is asked for). A replica that cannot reach its device exits,
    and the supervisor raises with its log; nothing falls back to the CPU.
    The replicas share one kernel build directory (``cache_dir``, passed as
    ``--cache-dir``): one build serves them all (ops/kernels._build locks
    the directory across processes).
  - **A replica is a rank group** (``ranks=``): the JAX package's replica
    is one process whose dispatches spread over every local device (its
    daemon's auto mesh); the port drives one card per process (the worker
    mesh, parallel/mesh.py), so a replica that spans the host's cards is a
    group of ``ranks`` processes of ``cli serve`` — rank 0 runs the fronts,
    the WAL, admission and the adoption endpoint, the other ranks follow
    its dispatches (serve/server.SweepServer.follow), one dispatch at a
    time across the ranks (serve/server.py's deviation). The default,
    ``ranks=None``, is every card of the host on ``cuda``
    (``torch.cuda.device_count()``, the JAX auto mesh's reach) and 1 on the
    CPU, so on a one-card host a replica is one process as before. Each
    rank keeps its own card and NCCL; ranks share a card only when asked
    (``share_card=True``, for more ranks than cards), and then run gloo
    (parallel/backend.resolve_card): a deliberate deviation, since NCCL
    refuses two ranks on one card. The group's ranks meet at a file store
    under the replica's own directory, new to each incarnation (a bounced group
    cannot meet at its previous store), and share one process group of
    their own, which the supervisor signals as one: a dead, stopped or
    bounced replica leaves no process behind. The supervisor reads rank
    0's exit code from rank 0 itself. A chaos spec is armed on rank 0 only,
    the one rank that runs the dispatch loop.
  - **Membership is evidential**, the same streak discipline the elastic
    controller applies to stragglers (elastic/controller.py,
    :class:`ProbeStreakDetector`): a replica is declared dead only after
    K CONSECUTIVE missed /healthz probes *while actually probing* —
    one timeout is a hiccup, a paused probe is not evidence, and any
    answered probe resets the streak. A group answers only when rank 0's
    /healthz does and every rank's process runs.
  - **On declared death**, the whole group is made dead, and the next
    live replica in the dead one's ring order ADOPTS its WAL (``POST
    /v1/adopt`` -> server.adopt_wal -> wal.adopt): O_EXCL sentinel so the
    adoption race has one winner, a final owner-/healthz refusal, dedup by
    request_digest against the adopter's own acceptances; an adopter that
    is a group replays the records on its rank 0, which broadcasts their
    dispatches to its followers. Accepted-never-lost now spans the fleet.
  - **Rolling deploy** (:meth:`FleetSupervisor.rolling_deploy`): each
    replica in turn is drained (out of the hash ring until it is back,
    whatever its probes answer meanwhile; in-flight work finishes),
    stopped, restarted on the same directories (its WAL
    replays warm against the shared kernel build directory), and
    re-admitted once /healthz answers — under load, with zero
    accepted-then-lost rows (chip_smoke.py's ``fleet`` phase drives this
    on the card at about twice what the survivors finish).

Every transition is a typed ``fleet`` event (obs/events.py): probe
misses surface as ``suspect`` with the live streak, ``declare_dead``
carries streak >= K (the validator REFUSES a death declared early),
``adopt`` carries the replayed record count, ``deploy_phase`` narrates
the drain/stop/ready arc of each bounce.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from erasurehead_tpu_torch.elastic.controller import ProbeStreakDetector
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.parallel import backend as backend_lib
from erasurehead_tpu_torch.serve.router import FleetRouter, VNODES
from erasurehead_tpu_torch.serve.wal import WAL_NAME

#: default evidential streak before a replica is declared dead
DEFAULT_K = 3

#: default seconds between membership probe sweeps
DEFAULT_PROBE_INTERVAL_S = 0.5

#: seconds a dead rank 0's followers get to end by themselves (each ends at
#: its next collective, once rank 0's connection closes) before they are
#: killed
FOLLOWER_GRACE_S = 5.0

#: the variables that place a process in a group: the supervisor sets them
#: for a group's ranks and clears them for a replica of one process
_GROUP_ENV = (*backend_lib.CLUSTER_ENV, backend_lib.INIT_METHOD_ENV,
              backend_lib.SHARE_CARD_ENV)

#: the directory that holds the erasurehead_tpu_torch package
_PKG_PARENT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class Replica:
    """One fleet member: its processes, endpoints, and durable state. A
    replica of ``ranks`` processes is a rank group: ``proc`` is rank 0 (the
    fronts), ``followers`` the others in rank order, all in one process
    group whose id is rank 0's pid."""

    def __init__(self, name: str, journal_dir: str, cache_dir: str,
                 events_path: Optional[str], log_path: str, ranks: int = 1):
        self.name = name
        self.journal_dir = journal_dir
        self.cache_dir = cache_dir
        self.events_path = events_path
        self.log_path = log_path
        self.ranks = int(ranks)
        self.proc: Optional[subprocess.Popen] = None
        self.followers: list = []
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.restarts = 0
        #: log size at the latest spawn — _wait_front must only parse
        #: lines THIS incarnation wrote (the log appends across bounces,
        #: and a bounced replica's first startup line names a dead port)
        self.log_offset = 0
        #: seconds from the latest spawn to its first answered /healthz
        self.boot_s: Optional[float] = None
        #: the latest incarnation's rendezvous (a group's file store)
        self.rendezvous: Optional[str] = None
        #: each rank's exit code once the latest incarnation ended
        self.exit_codes: Optional[list] = None
        self._t_launch = 0.0

    @property
    def wal_path(self) -> str:
        return os.path.join(self.journal_dir, WAL_NAME)

    @property
    def hostport(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def procs(self) -> list:
        """Every process of the latest incarnation, in rank order."""
        return ([self.proc] if self.proc is not None else []) + list(self.followers)

    def rank_log_path(self, rank: int) -> str:
        """Rank 0 writes the replica's log; rank r > 0 its own beside it."""
        if rank == 0:
            return self.log_path
        return f"{os.path.splitext(self.log_path)[0]}.rank{rank}.log"

    def whole(self) -> bool:
        """Does every process of the group still run? (True before a
        spawn: nothing of it has ended.)"""
        return all(p.poll() is None for p in self.procs)


def group_pids(pgid: Optional[int]) -> list:
    """The pids of every live process whose process group is ``pgid``, read
    from /proc (empty where there is none, or no /proc)."""
    if pgid is None:
        return []
    out = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return []
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid pgrp ...": comm may hold spaces and parens
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z" and int(fields[2]) == pgid:
            out.append(int(entry))
    return out


#: ``subprocess.Popen(process_group=)`` exists from Python 3.11
_POPEN_PROCESS_GROUP = sys.version_info >= (3, 11)


def _process_group_kw(pgid: int) -> dict:
    """Popen keywords that start the child in process group ``pgid`` (0: a
    new group, led by the child). Before Python 3.11 the child joins it
    itself, between fork and exec."""
    if _POPEN_PROCESS_GROUP:
        return {"process_group": pgid}
    return {"preexec_fn": lambda: os.setpgid(0, pgid)}


def _signal_group(rep: Replica, sig) -> None:
    """``sig`` to rep's process group, while any of its ranks runs (the
    group id is rank 0's pid, which cannot be reused while the group has a
    member)."""
    if rep.proc is None or (
        all(p.poll() is not None for p in rep.procs)
        and not group_pids(rep.proc.pid)
    ):
        return
    try:
        os.killpg(rep.proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def end_group(rep: Replica, sig=signal.SIGTERM, wait_s: float = 10.0) -> list:
    """End every process of rep's group: ``sig`` to the group, up to
    ``wait_s`` for each rank to exit, then SIGKILL to whatever of the group
    is left (grandchildren too). Returns each rank's exit code (also kept as
    ``rep.exit_codes``)."""
    procs = rep.procs
    if not procs:
        return []
    if sig is not None:
        _signal_group(rep, sig)
    deadline = time.monotonic() + wait_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    if any(p.poll() is None for p in procs) or group_pids(rep.proc.pid):
        _signal_group(rep, signal.SIGKILL)
        for p in procs:
            p.wait(timeout=10)
    rep.exit_codes = [p.returncode for p in procs]
    return rep.exit_codes


def _log_tail(rep: Replica, n: int = 4000) -> str:
    """The last ``n`` characters this incarnation wrote to its log, and to
    each follower's."""
    out = []
    for r in range(max(1, len(rep.procs))):
        path = rep.rank_log_path(r)
        try:
            with open(path) as f:
                f.seek(rep.log_offset if r == 0 else 0)
                text = f.read()[-n:]
        except OSError as e:
            text = f"<log unreadable: {e}>"
        out.append(text if r == 0 else f"--- rank {r} ({path}):\n{text}")
    return "\n".join(out)


def default_ranks(device: str) -> int:
    """Ranks a replica by default (the JAX auto mesh's reach): every card
    of the host on ``cuda`` (at least 1), 1 on the CPU."""
    if device == "cpu":
        return 1
    import torch

    return max(1, torch.cuda.device_count())


def probe_healthz(host: str, port: int,
                  timeout: float = 2.0) -> Optional[dict]:
    """One /healthz probe: the parsed body on a 200, None on ANY
    failure (refused, timeout, non-200, bad JSON) — a probe never
    raises, it just reports what it saw."""
    import http.client

    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return json.loads(resp.read() or b"{}")
        finally:
            conn.close()
    except (OSError, ValueError):
        return None


class FleetSupervisor:
    """Spawns, probes, and bounces a same-host serve fleet.

    ``ranks``: processes a replica (module docstring), an int for every
    replica or ``{name: ranks}`` for the named ones (the others take the
    default); None is :func:`default_ranks`. More ranks than the host has
    cards on ``cuda`` is refused unless ``share_card`` asks for ranks that
    share a card (gloo)."""

    #: the replica's command, before its flags (a caller may replace it,
    #: e.g. with a ``-c`` program that prepares the process, then runs
    #: ``cli.main(["serve", *sys.argv[1:]])``)
    serve_cmd = (sys.executable, "-m", "erasurehead_tpu_torch.cli", "serve")

    def __init__(
        self,
        n: int = 3,
        base_dir: Optional[str] = None,
        router_host: str = "127.0.0.1",
        router_port: int = 0,
        k: int = DEFAULT_K,
        probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
        window_ms: float = 50.0,
        cache_dir: Optional[str] = None,
        vnodes: int = VNODES,
        chaos: Optional[dict] = None,
        extra_args: tuple = (),
        device: str = "cuda",
        ranks=None,
        share_card: bool = False,
    ):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.n = int(n)
        self.device = device
        self.share_card = bool(share_card)
        default = default_ranks(device)
        if ranks is None or isinstance(ranks, dict):
            named = dict(ranks or {})
        else:
            named, default = {}, int(ranks)
        self._default_ranks = default
        self._named_ranks = {name: int(r) for name, r in named.items()}
        for r in (default, *self._named_ranks.values()):
            self._check_ranks(r)
        if base_dir is None:
            base_dir = tempfile.mkdtemp(prefix="eh-fleet-")
        self.base_dir = base_dir
        # ONE kernel build directory for the whole fleet: a bounced
        # replica (and every replica after the first) loads the library
        # its peers already built
        self.cache_dir = cache_dir or os.path.join(base_dir, "cache")
        self.window_ms = float(window_ms)
        self.router = FleetRouter(router_host, router_port, vnodes=vnodes)
        self.detector = ProbeStreakDetector(k=k)
        self.probe_interval_s = float(probe_interval_s)
        #: replica name -> chaos spec armed on ITS rank 0 only
        self.chaos = dict(chaos or {})
        self.extra_args = tuple(extra_args)
        self.replicas: dict[str, Replica] = {}
        self._dead_handled: set[str] = set()
        self._deploying: Optional[str] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def _check_ranks(self, ranks: int) -> None:
        if ranks < 1:
            raise ValueError(f"a replica needs at least one rank, got {ranks}")
        if self.device != "cuda" or self.share_card:
            return
        import torch

        cards = torch.cuda.device_count()
        if ranks > max(1, cards):
            raise ValueError(
                f"{ranks} ranks a replica on a host with {cards} card(s): "
                "each rank needs a card of its own unless share_card=True "
                "asks for ranks that share one (gloo: NCCL refuses two "
                "ranks on one card)"
            )

    def ranks_of(self, name: str) -> int:
        """Processes of replica ``name``."""
        return self._named_ranks.get(name, self._default_ranks)

    # ---- lifecycle -------------------------------------------------------

    def start(self, probe: bool = True) -> None:
        # every replica boots at once; each joins the ring as it answers
        for rep in [self._launch(f"r{i}") for i in range(self.n)]:
            self._admit(rep)
        if probe:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="eh-fleet-probe",
                daemon=True,
            )
            self._probe_thread.start()

    def spawn(self, name: str) -> Replica:
        """Launch one replica (or relaunch a bounced one on its same
        directories), wait for its HTTP front, and admit it to the
        ring with a clean probe slate."""
        return self._admit(self._launch(name))

    def _launch(self, name: str) -> Replica:
        """Start replica ``name``'s processes: one ``cli serve``, or a rank
        group of them meeting at a file store new to this incarnation, all
        in one process group whose id is rank 0's pid."""
        rep = self.replicas.get(name)
        if rep is None:
            rep = Replica(
                name=name,
                journal_dir=os.path.join(self.base_dir, name),
                cache_dir=self.cache_dir,
                events_path=os.path.join(
                    self.base_dir, f"{name}.events.jsonl"
                ),
                log_path=os.path.join(self.base_dir, f"{name}.log"),
                ranks=self.ranks_of(name),
            )
            self.replicas[name] = rep
        else:
            rep.restarts += 1
        os.makedirs(rep.journal_dir, exist_ok=True)
        env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV}
        # the replica imports this checkout's package wherever it runs
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p
        )
        env.pop("ERASUREHEAD_CHAOS", None)
        if rep.ranks > 1:
            # a store no earlier incarnation met at
            for old in os.listdir(rep.journal_dir):
                path = os.path.join(rep.journal_dir, old)
                if old.startswith("rendezvous.") and os.path.isfile(path):
                    os.remove(path)
            rep.rendezvous = os.path.join(
                rep.journal_dir, f"rendezvous.{rep.restarts}"
            )
            env.update({
                "WORLD_SIZE": str(rep.ranks),
                backend_lib.INIT_METHOD_ENV: "file://" + rep.rendezvous,
            })
            if self.share_card and self.device == "cuda":
                env[backend_lib.SHARE_CARD_ENV] = "1"
        sock = os.path.join(self.base_dir, f"{name}.sock")
        cmd = [
            *self.serve_cmd,
            "--socket", sock,
            "--http", "127.0.0.1:0",
            "--replica-name", name,
            "--journal-dir", rep.journal_dir,
            "--cache-dir", rep.cache_dir,
            "--events", rep.events_path,
            "--window-ms", str(self.window_ms),
            "--device", self.device,
            *self.extra_args,
        ]
        rep.log_offset = (
            os.path.getsize(rep.log_path)
            if os.path.exists(rep.log_path) else 0
        )
        rep.host = rep.port = None  # a bounce gets a fresh kernel port
        rep.proc, rep.followers, rep.exit_codes = None, [], None
        rep._t_launch = time.monotonic()
        for r in range(rep.ranks):
            renv = dict(env)
            if rep.ranks > 1:
                renv.update(RANK=str(r), LOCAL_RANK=str(r))
            if r == 0 and self.chaos.get(name):
                renv["ERASUREHEAD_CHAOS"] = self.chaos[name]
            try:
                with open(rep.rank_log_path(r), "a") as out:
                    proc = subprocess.Popen(
                        cmd, env=renv, stdout=out, stderr=subprocess.STDOUT,
                        **_process_group_kw(0 if r == 0 else rep.proc.pid),
                    )
            except OSError:
                end_group(rep, signal.SIGKILL, 0.0)
                raise
            if r == 0:
                rep.proc = proc
            else:
                rep.followers.append(proc)
        return rep

    def _admit(self, rep: Replica) -> Replica:
        """Wait for a launched replica's front, then join it to the ring
        with a clean probe slate."""
        try:
            self._wait_front(rep)
        except RuntimeError:
            end_group(rep, signal.SIGKILL, 0.0)
            raise
        rep.boot_s = time.monotonic() - rep._t_launch
        name = rep.name
        self.router.add_replica(name, rep.host, rep.port)
        self.detector.add(name)
        self._dead_handled.discard(name)
        events_lib.emit("fleet", action="join", replica=name)
        return rep

    def _wait_front(self, rep: Replica, timeout: float = 600.0) -> None:
        """Parse the replica's own startup line for its kernel-assigned
        HTTP port, then wait until /healthz actually answers. A group's
        rank 0 listens only once every rank has joined."""
        deadline = time.time() + timeout
        marker = "serve: http front on "
        while time.time() < deadline:
            ended = [(r, p.returncode) for r, p in enumerate(rep.procs)
                     if p.poll() is not None]
            if ended:
                r, code = ended[0]
                raise RuntimeError(
                    f"replica {rep.name} exited {code} before listening"
                    + (f" (rank {r})" if rep.ranks > 1 else "")
                    + f" (log: {rep.log_path}):\n{_log_tail(rep)}"
                )
            try:
                with open(rep.log_path) as f:
                    f.seek(rep.log_offset)
                    for line in f:
                        if marker in line:
                            hostport = (
                                line.split(marker, 1)[1].split()[0]
                            )
                            host, _, port = hostport.rpartition(":")
                            rep.host, rep.port = host, int(port)
                            break
            except OSError:
                pass
            if rep.port is not None and probe_healthz(
                rep.host, rep.port
            ) is not None:
                return
            time.sleep(0.2)
        raise RuntimeError(
            f"replica {rep.name} never brought up its http front "
            f"(log: {rep.log_path}):\n{_log_tail(rep)}"
        )

    def stop(self) -> None:
        """Stop the probes, end every replica's group (SIGTERM to each
        group at once; what is left after 10 s is killed), close the
        router."""
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
        for rep in self.replicas.values():
            _signal_group(rep, signal.SIGTERM)
        for rep in self.replicas.values():
            end_group(rep, None, 10.0)
        self.router.close()

    # ---- membership ------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the probe loop must live
                pass
            self._stop.wait(self.probe_interval_s)

    def probe_once(self) -> None:
        """One membership sweep: probe every replica not already dead,
        feed the evidence to the streak detector, and handle any death
        it declares. A replica mid-deploy is probed but the evidence is
        DISCARDED (evidential=False): a deliberate bounce is not
        evidence of death. Nor does its answered probe put it back in
        the ring (the JAX supervisor's does): new work routed to a
        replica that is draining would keep its queue from emptying and
        wait out its restart in the WAL; ``spawn`` re-admits it. A group
        answers only when rank 0's /healthz does and every rank runs: a
        group that lost a rank cannot dispatch."""
        with self._lock:
            names = [
                n for n in self.replicas
                if n not in self._dead_handled
            ]
            deploying = self._deploying
        for name in names:
            rep = self.replicas[name]
            body = (
                probe_healthz(rep.host, rep.port)
                if rep.port is not None and rep.whole()
                else None
            )
            ok = body is not None
            evidential = name != deploying
            streak = self.detector.observe(
                name, ok, evidential=evidential
            )
            if ok:
                with self._lock:
                    if name != self._deploying:
                        self.router.set_alive(
                            name, True, pressure=body.get("admission")
                        )
                continue
            if not evidential:
                continue
            if self.detector.is_dead(name):
                self._declare_dead(name, streak)
            else:
                events_lib.emit(
                    "fleet", action="suspect", replica=name,
                    streak=streak, k=self.detector.k,
                )

    def _declare_dead(self, name: str, streak: int) -> None:
        """K consecutive evidential misses: out of the ring, and the
        next live peer in ITS ring order adopts its WAL. The whole group
        is made dead first when rank 0 still runs; when rank 0 is dead, its
        followers get FOLLOWER_GRACE_S to end by themselves after the
        adoption, then whatever is left of the group is killed."""
        with self._lock:
            if name in self._dead_handled:
                return
            self._dead_handled.add(name)
        events_lib.emit(
            "fleet", action="declare_dead", replica=name,
            streak=streak, k=self.detector.k,
        )
        rep = self.replicas[name]
        self.router.set_alive(name, False)
        if rep.proc is not None and rep.proc.poll() is None:
            # unreachable but still running (wedged), or a rank of its
            # group is gone: make death true before a peer adopts its WAL
            end_group(rep, signal.SIGKILL, 0.0)
        try:
            for peer in self.router.ring.ring_order(name):
                if peer == name or peer in self._dead_handled:
                    continue
                if self._command_adoption(peer, rep):
                    return
        finally:
            end_group(rep, None, FOLLOWER_GRACE_S)
        events_lib.emit(
            "warning",
            kind="fleet_no_adopter",
            message=(
                f"fleet: no live peer could adopt {name}'s WAL "
                f"({rep.wal_path}); its acceptances replay when a "
                f"replica restarts on that directory"
            ),
        )

    def _command_adoption(self, peer: str, dead: Replica) -> bool:
        """POST /v1/adopt to ``peer``: adopt the dead replica's WAL.
        The peer re-checks the owner's /healthz itself before touching
        the file (server.adopt_wal -> wal.adopt)."""
        import http.client

        ep = self.router.endpoint_of(peer)
        peer_rep = self.replicas.get(peer)
        if ep is None or (peer_rep is not None and not peer_rep.whole()):
            return False  # a group that lost a rank cannot dispatch
        body = json.dumps(
            {
                "path": dead.wal_path,
                "replica": dead.name,
                "owner": dead.hostport,
            }
        )
        try:
            conn = http.client.HTTPConnection(ep[0], ep[1], timeout=30.0)
            try:
                conn.request(
                    "POST", "/v1/adopt", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            return False
        if resp.status == 202:
            self.router.adoptions_total += 1
            _METRICS.counter("fleet.adoptions").inc()
            return True
        if resp.status == 409:
            # already adopted: the race had a winner — that is success
            self.router.adoptions_total += 1
            return True
        return False

    # ---- rolling deploy --------------------------------------------------

    def rolling_deploy(self, drain_timeout_s: float = 120.0) -> dict:
        """Bounce every replica in sequence with zero downtime: drain it
        out of the hash ring (peers absorb new submissions), stop it
        once idle, restart it on its same directories (the WAL replays
        anything a hard stop stranded), and re-admit it once /healthz
        answers. Returns per-replica timing."""
        phases: dict[str, dict] = {}
        for name in sorted(self.replicas):
            if name in self._dead_handled:
                continue
            rep = self.replicas[name]
            t0 = time.monotonic()
            events_lib.emit(
                "fleet", action="deploy_phase", replica=name, phase="drain",
            )
            with self._lock:
                # under the lock probe_once re-admits under: no probe
                # answered before this line puts the replica back
                self._deploying = name
                self.router.set_alive(name, False)
            try:
                self._drain(rep, drain_timeout_s)
                events_lib.emit(
                    "fleet", action="deploy_phase", replica=name,
                    phase="stop",
                )
                end_group(rep, signal.SIGTERM, 30.0)
                rep.host = rep.port = None
                self.spawn(name)  # same dirs: WAL replays, cache warm
                events_lib.emit(
                    "fleet", action="deploy_phase", replica=name,
                    phase="ready",
                )
            finally:
                with self._lock:
                    self._deploying = None
            phases[name] = {
                "bounce_s": round(time.monotonic() - t0, 3),
                "restarts": rep.restarts,
            }
        return phases

    def _drain(self, rep: Replica, timeout_s: float) -> None:
        """Wait until the router has no submit open against the replica,
        then until the replica reports an empty queue and no in-flight
        dispatches (bounded): nothing accepted is abandoned mid-bounce —
        and anything that slips through is exactly what the WAL replay
        exists for. (The JAX supervisor probes at once, so a submit
        proxied before the replica left the ring could land after the
        probe saw it idle and wait out the restart in the WAL.)"""
        deadline = time.monotonic() + timeout_s
        self.router.wait_proxies(rep.name, timeout_s)
        while time.monotonic() < deadline:
            body = probe_healthz(rep.host, rep.port) if rep.whole() else None
            if body is None:
                return  # already gone; WAL replay covers it
            if not body.get("queued") and not body.get("in_flight"):
                return
            time.sleep(0.2)

    # ---- introspection ---------------------------------------------------

    def endpoints(self) -> dict:
        return {
            "router": f"{self.router.host}:{self.router.port}",
            "replicas": {
                name: rep.hostport
                for name, rep in sorted(self.replicas.items())
                if rep.port is not None
            },
        }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m erasurehead_tpu_torch.cli fleet",
        description="Run N serve replicas behind a consistent-hash "
                    "router with evidential membership, WAL adoption "
                    "on death, and zero-downtime rolling deploys.",
    )
    p.add_argument("--replicas", type=int, default=3,
                   help="fleet size (default 3)")
    p.add_argument("--http", default="127.0.0.1:0", metavar="HOST:PORT",
                   help="router bind address (default 127.0.0.1:0 — "
                        "kernel-assigned port, printed on stdout)")
    p.add_argument("--base-dir", default=None, metavar="DIR",
                   help="fleet state root: per-replica journal dirs + "
                        "WALs, the shared kernel build directory, logs "
                        "(default: a fresh temp dir)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="the replicas' shared kernel build directory "
                        "(default: <base-dir>/cache); point it at a "
                        "directory that holds a build and no replica "
                        "runs nvcc")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every replica trains (default: the card; "
                        "a replica without one exits and the fleet "
                        "raises with its log). On the card a replica is "
                        "a group of one rank per card of the host")
    p.add_argument("--k", type=int, default=DEFAULT_K,
                   help="evidential streak before a replica is "
                        f"declared dead (default {DEFAULT_K}; "
                        "a probe that was not attempted never counts)")
    p.add_argument("--probe-interval", type=float,
                   default=DEFAULT_PROBE_INTERVAL_S, metavar="SECONDS",
                   help="seconds between membership probe sweeps "
                        f"(default {DEFAULT_PROBE_INTERVAL_S})")
    p.add_argument("--window-ms", type=float, default=50.0,
                   help="per-replica admission window (default 50)")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="capture the supervisor's fleet events to this "
                        "JSONL file (each replica always journals its "
                        "own under --base-dir)")
    p.add_argument("--chaos", action="append", default=[],
                   metavar="REPLICA=SPEC",
                   help="arm an ERASUREHEAD_CHAOS spec on one replica's "
                        "process only (repeatable), e.g. "
                        "r1=kill:fleet_replica:2: that replica dies at "
                        "its 2nd cohort dispatch and a peer adopts its "
                        "WAL (the supervisor's own environment never "
                        "arms a replica)")
    p.add_argument("--rolling-deploy", action="store_true",
                   help="after the fleet is healthy, run one rolling "
                        "deploy drill and exit (for runbooks/CI; the "
                        "default is to serve until interrupted)")
    ns = p.parse_args(argv)
    from erasurehead_tpu_torch.utils import chaos as chaos_lib

    chaos = {}
    for item in ns.chaos:
        name, sep, spec = item.partition("=")
        if not sep or not name or not spec:
            p.error(f"--chaos wants REPLICA=SPEC, got {item!r}")
        try:  # a bad spec fails here, not in a replica
            for one in spec.split(","):
                chaos_lib.parse_spec(one)
        except ValueError as e:
            p.error(str(e))
        chaos[name] = spec

    from erasurehead_tpu_torch.serve.http_front import parse_hostport

    host, port = parse_hostport(ns.http)
    import contextlib

    capture = (
        events_lib.capture(ns.events)
        if ns.events
        else contextlib.nullcontext()
    )
    with capture:
        sup = FleetSupervisor(
            n=ns.replicas,
            base_dir=ns.base_dir,
            router_host=host,
            router_port=port,
            k=ns.k,
            probe_interval_s=ns.probe_interval,
            window_ms=ns.window_ms,
            cache_dir=ns.cache_dir,
            device=ns.device,
            chaos=chaos,
        )
        sup.start()
        eps = sup.endpoints()
        print(
            f"fleet: router on {eps['router']} "
            f"({ns.replicas} replicas of {sup.ranks_of('r0')} rank(s), "
            f"k={ns.k}, device {ns.device})",
            flush=True,
        )
        for name, hp in eps["replicas"].items():
            print(f"fleet: replica {name} on {hp}", flush=True)
        try:
            if ns.rolling_deploy:
                phases = sup.rolling_deploy()
                print(json.dumps({"rolling_deploy": phases}), flush=True)
            else:
                while True:
                    time.sleep(0.5)
        except KeyboardInterrupt:
            print("fleet: shutting down", flush=True)
        finally:
            sup.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
