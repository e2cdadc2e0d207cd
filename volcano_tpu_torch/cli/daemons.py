"""The port's daemon entry points: the scheduler as its own OS process.

The port's copy of the scheduler half of ``volcano_tpu/cli/daemons.py``.
The reference ships its scheduler as a binary of its own that meets the
other components at the API server; here it runs against an apiserver of
either package through ``RemoteStore``:

  python -m volcano_tpu_torch.cli apiserver --port 0 [--state F [--wal]] [--shards N]
  python -m volcano_tpu_torch.cli scheduler --server http://127.0.0.1:8443

``run_scheduler`` is the JAX daemon's: leader election through a store
Lease by default, the deployed apply mode ``async`` unless the conf file
names ``applyMode``, a mirror checkpoint every 30 cycles when
``VOLCANO_TPU_MIRROR_CKPT`` or the conf names a path, the boot and outage
retries on ``Backoff``, the prewarm, then the metrics server, and the mesh
host count and id from the flags or ``VOLCANO_TPU_MESH_HOSTS`` /
``VOLCANO_TPU_MESH_HOST_ID``.  It arms the time-series recorder from
``VOLCANO_TPU_TIMESERIES`` at boot.  Where it departs from the JAX daemon:

* the backend: ``VOLCANO_TPU_BACKEND`` unset or ``tpu`` runs on the card
  (``cuda``), ``cpu`` on the plain PyTorch versions (how a caller asks for
  the CPU); ``host`` and ``native`` raise ValueError, as the conf loader
  does;
* no fallback: with no card and no request for the CPU the Scheduler's
  RuntimeError ends the process before its first cycle (the JAX daemon
  falls back to its native tier when jax is missing);
* no compile cache to arm: the kernel build directory persists;
* ``--peers`` raises, naming ROADMAP item 11b part 3 (replication);
* the leader elector has no chaos clock (item 13).

The JAX package's other subcommands exit non-zero naming the item they come
with (``LATER_COMMANDS``).
"""

from __future__ import annotations

import os
import signal
import sys
import time

#: the JAX package's subcommands the port does not have, and the ROADMAP
#: item each comes with
LATER_COMMANDS = {
    "controller": "the controllers (ROADMAP item 12)",
    "kubelet": "the controllers (ROADMAP item 12)",
    "elastic": "the controllers (ROADMAP item 12)",
    "replica": "replication (ROADMAP item 11b part 3)",
    "shard": "the process mesh (ROADMAP item 11b part 4)",
    **{c: "the tooling, cli/vtctl.py (ROADMAP item 13)"
       for c in ("job", "node", "pool", "describe", "events", "trace", "top", "profile",
                 "audit", "cluster", "up", "down")},
}

LATER_PEERS = "--peers comes with replication (ROADMAP item 11b part 3)"


def _transient_errors():
    """The errors an apiserver outage surfaces through RemoteStore: a
    connection failure (OSError), a server-side 5xx (RemoteStoreError) and
    a reply cut mid-body (http.client.HTTPException, not an OSError)."""
    import http.client

    from volcano_tpu_torch.store.client import RemoteStoreError

    return (RemoteStoreError, OSError, http.client.HTTPException)


def _peer_list(peers: str):
    """``--peers``' comma list; None when unset.  A list raises: the port's
    RemoteStore has no replica set."""
    urls = [p.strip() for p in peers.split(",") if p.strip()]
    if urls:
        raise ValueError(LATER_PEERS)
    return None


def _elector(store, component: str, identity: str, enabled: bool):
    if not enabled:
        return None
    from volcano_tpu_torch.leader import LeaderElector

    return LeaderElector(store, name=component, identity=identity)


def backend_from_env() -> str:
    """The deployed backend of a daemon without a conf file, from
    ``VOLCANO_TPU_BACKEND``: unset or ``tpu`` -> ``cuda``; ``cuda`` and
    ``cpu`` stay; ``host`` and ``native`` raise ValueError."""
    raw = os.environ.get("VOLCANO_TPU_BACKEND", "").strip() or "tpu"
    if raw == "tpu":
        return "cuda"
    if raw in ("host", "native"):
        raise ValueError(f"VOLCANO_TPU_BACKEND={raw} has no counterpart in the port (no "
                         "object oracle or C++ solver tier); leave it unset for the card, "
                         "or set cpu for the plain PyTorch versions")
    return raw


def run_scheduler(server: str, conf_path: str = "", identity: str = "",
                  leader_elect: bool = True, period: float = 1.0,
                  metrics_port: int = 8080, announce=print,
                  peers: str = "", mesh_hosts: int = 0, mesh_host_id: int = -1) -> None:
    """Cycle a scheduler against ``server`` every ``period`` seconds until
    the process ends.  The schedule period defaults to the reference's 1 s
    and /metrics to :8080; ``metrics_port`` < 0 disables the endpoint, 0
    picks a free port."""
    boot_t0 = time.monotonic()
    from volcano_tpu_torch import timeseries, trace
    from volcano_tpu_torch.backoff import Backoff
    from volcano_tpu_torch.scheduler.conf import full_conf, load_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.store.client import RemoteStore

    trace.set_component("scheduler")
    timeseries.arm_from_env()
    _peer_list(peers)
    if conf_path:
        with open(conf_path) as f:
            # the deployed default: decisions ship async unless the file
            # names applyMode
            conf = load_conf(f.read(), apply_mode_default="async")
    else:
        conf = full_conf(backend_from_env())
        conf.apply_mode = "async"
    # the multi-controller launch: the flag, else the environment, else
    # the conf.  One scheduler process a mesh host; host 0 coordinates
    if mesh_hosts <= 0:
        mesh_hosts = int(os.environ.get("VOLCANO_TPU_MESH_HOSTS", "0"))
    if mesh_host_id < 0:
        mesh_host_id = int(os.environ.get("VOLCANO_TPU_MESH_HOST_ID", "-1"))
    if mesh_hosts > 0:
        conf.mesh_hosts = mesh_hosts
    if mesh_host_id >= 0:
        conf.mesh_host_id = mesh_host_id
    if conf.mesh_hosts > 1:
        if not 0 <= conf.mesh_host_id < conf.mesh_hosts:
            raise SystemExit(f"--mesh-host-id {conf.mesh_host_id} out of range for "
                             f"--mesh-hosts {conf.mesh_hosts}")
        # every host runs every cycle in lockstep: an election would
        # silence all but one; the identity stays unique a host
        leader_elect = False
        identity = (identity or f"scheduler-{os.getpid()}") + f"-host{conf.mesh_host_id}"
    if conf.mirror_checkpoint is None:
        ckpt_env = os.environ.get("VOLCANO_TPU_MIRROR_CKPT")
        if ckpt_env:
            conf.mirror_checkpoint = ckpt_env
    ident = identity or f"scheduler-{os.getpid()}"
    boot = Backoff(base=min(max(period, 0.01), 0.5))
    while True:
        try:
            # construction subscribes the mirror's watches over the wire: a
            # 5xx or a reset at boot retries.  The store is new each
            # attempt, so that a failed one leaves no orphaned watch queue
            store = RemoteStore(server)
            sched = Scheduler(store, conf=conf,
                              elector=_elector(store, "vk-scheduler", ident, leader_elect))
            break
        except _transient_errors() as e:
            announce(f"scheduler {ident}: store unavailable at boot ({e}); retrying",
                     flush=True)
            boot.sleep()
    announce(f"scheduler {ident} cycling every {period}s against {server} on "
             f"{sched.device}", flush=True)
    try:
        warm = sched.prewarm()
    except _transient_errors() as e:
        announce(f"scheduler {ident}: prewarm skipped (store unavailable: {e})", flush=True)
    else:
        announce(f"scheduler {ident}: solves warm in {warm:.3f}s", flush=True)
    if metrics_port >= 0:
        from volcano_tpu_torch.scheduler.metrics_server import MetricsServer

        ms = MetricsServer(port=metrics_port).start()
        announce(f"metrics on http://127.0.0.1:{ms.port}/metrics", flush=True)
    transient = _transient_errors()
    down = False
    cycles = 0
    retry = Backoff(base=min(max(period, 0.01), 0.5))
    while True:
        t0 = time.monotonic()
        try:
            sched.run_once()
            retry.reset()
            if down:
                announce(f"scheduler {ident}: store back", flush=True)
                down = False
        except transient as e:
            if not down:
                announce(f"scheduler {ident}: store unavailable ({e}); retrying", flush=True)
                down = True
            # the outage retry on jittered backoff; a healthy cycle keeps
            # the fixed schedule period below
            retry.sleep()
            continue
        cycles += 1
        if cycles == 1:
            announce(f"scheduler {ident}: first cycle ({sched.last_path}) done "
                     f"{time.monotonic() - boot_t0:.3f}s after boot", flush=True)
        if sched.conf.mirror_checkpoint and cycles % 30 == 0:
            # between cycles the state is consistent; skipped inside while
            # async decisions are in flight
            try:
                sched.save_mirror_checkpoint()
            except Exception as e:  # noqa: BLE001 — never kill the loop
                announce(f"scheduler {ident}: mirror checkpoint failed: {e}", flush=True)
        time.sleep(max(0.0, period - (time.monotonic() - t0)))


def install_sigterm_exit() -> None:
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))


def _parser():
    import argparse

    parser = argparse.ArgumentParser(prog="python -m volcano_tpu_torch.cli")
    # accepted before and after the subcommand; SUPPRESS keeps the
    # subparser from clobbering a value given at the top level
    parser.add_argument("--server", default="", help="the apiserver's URL")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--server", default=argparse.SUPPRESS)
    sub = parser.add_subparsers(dest="group", required=True)

    api = sub.add_parser("apiserver", parents=[common], help="run the port's apiserver")
    api.add_argument("--port", type=int, default=8443, help="0 picks a free port")
    api.add_argument("--host", default="127.0.0.1")
    api.add_argument("--state", default="", help="the state file (durable objects)")
    api.add_argument("--wal", action="store_true",
                     help="the write-ahead log beside --state")
    api.add_argument("--shards", type=int, default=1,
                     help="partition the decision bus into this many namespace shards")
    api.add_argument("--no-default-queue", action="store_true")
    for flag in ("--replica-of", "--peers", "--repl-ack", "--identity"):
        api.add_argument(flag, default="", help="replication (ROADMAP item 11b part 3)")
    api.add_argument("--lease-duration", type=float, default=None,
                     help="replication (ROADMAP item 11b part 3)")
    api.add_argument("--proc-shards", type=int, default=0,
                     help="the process mesh (ROADMAP item 11b part 4)")
    api.add_argument("--proc-replicas", type=int, default=1,
                     help="the process mesh (ROADMAP item 11b part 4)")

    p = sub.add_parser("scheduler", parents=[common], help="run the scheduler against --server")
    p.add_argument("--identity", default="")
    p.add_argument("--peers", default="", help=LATER_PEERS)
    p.add_argument("--period", type=float, default=1.0)
    p.add_argument("--no-leader-elect", action="store_true")
    p.add_argument("--conf", default="", help="scheduler-conf YAML path")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="/metrics port (0 = free port, <0 = disabled)")
    p.add_argument("--mesh-hosts", type=int, default=0,
                   help="multi-controller launch: the mesh's host count (one scheduler "
                        "process a host; 0 = the conf or VOLCANO_TPU_MESH_HOSTS)")
    p.add_argument("--mesh-host-id", type=int, default=-1,
                   help="this process's host id, 0-based (0 = the coordinator; -1 = the "
                        "conf or VOLCANO_TPU_MESH_HOST_ID)")
    return parser


def _apiserver_later(args) -> str:
    """The item the apiserver flags given wait for, or ""."""
    if args.replica_of or args.peers or args.repl_ack or args.identity \
            or args.lease_duration is not None:
        return "replication (ROADMAP item 11b part 3)"
    if args.proc_shards or args.proc_replicas != 1:
        return "the process mesh (ROADMAP item 11b part 4)"
    return ""


def _subcommand(argv) -> str:
    """The first word of ``argv`` that is neither an option nor the top
    level ``--server``'s value."""
    skip = False
    for tok in argv:
        if skip:
            skip = False
        elif tok == "--server":
            skip = True
        elif not tok.startswith("-"):
            return tok
    return ""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = _subcommand(argv)
    if cmd in LATER_COMMANDS:
        print(f"error: the {cmd} subcommand comes with {LATER_COMMANDS[cmd]}", file=sys.stderr)
        return 2
    args = _parser().parse_args(argv)
    if args.group == "apiserver":
        later = _apiserver_later(args)
        if later:
            print(f"error: those apiserver flags come with {later}", file=sys.stderr)
            return 2
        if args.wal and not args.state:
            print("error: --wal requires --state", file=sys.stderr)
            return 2
        if args.shards < 1:
            print("error: --shards must be at least 1", file=sys.stderr)
            return 2
        from volcano_tpu_torch.store.server import run_apiserver

        run_apiserver(port=args.port, host=args.host, state=args.state, wal=args.wal,
                      shards=args.shards, default_queue=not args.no_default_queue)
        return 0
    if not args.server:
        print("error: --server is required", file=sys.stderr)
        return 1
    install_sigterm_exit()
    run_scheduler(args.server, conf_path=args.conf, identity=args.identity,
                  leader_elect=not args.no_leader_elect, period=args.period,
                  metrics_port=args.metrics_port, peers=args.peers,
                  mesh_hosts=args.mesh_hosts, mesh_host_id=args.mesh_host_id)
    return 0
