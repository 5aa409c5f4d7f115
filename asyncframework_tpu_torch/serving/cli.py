"""The serving-tier process entry point (the JAX package's
``async-serve``).

Two roles::

    # a predict replica subscribed to a PS, optionally HELLOing a frontend
    python -m asyncframework_tpu_torch.serving.cli replica --ps HOST:PORT \
        [--port P] [--frontend HOST:PORT] [--rid N]
        [--loss least_squares|logistic] [--conf k=v ...]

    # a frontend: replica registration front door + client predict proxy
    python -m asyncframework_tpu_torch.serving.cli frontend [--port P] \
        [--replicas h:p,h:p,...] [--conf k=v ...]

Each role prints ONE JSON line on stdout once bound (``{"role": ...,
"port": ...}``, the JAX package's line) so launchers (tests,
``chip_smoke.py``, readiness wrappers) can parse the ephemeral port, then
serves until SIGTERM/EOF.  ``--conf`` overlays any registered
``async.serve.*`` / ``async.net.*`` knob, same precedence as the recipe
CLI (``cli.parse_conf_overlays``).

A replica holds its model on the first CUDA device; with
``ASYNCTPU_FORCE_CPU=1`` on the CPU.  Without a card and without the
variable it raises before binding anything.  The frontend holds no model
and needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="async-serve", description=__doc__.split("\n\n")[0]
    )
    sub = p.add_subparsers(dest="role", required=True)
    r = sub.add_parser("replica", help="snapshot-subscribing predict server")
    r.add_argument("--ps", required=True, metavar="HOST:PORT",
                   help="parameter server to SUBSCRIBE to")
    r.add_argument("--host", default="0.0.0.0")
    r.add_argument("--port", type=int, default=0,
                   help="predict port (0 = ephemeral, printed on stdout)")
    r.add_argument("--rid", type=int, default=0, help="replica id")
    r.add_argument("--loss", default="least_squares",
                   choices=["least_squares", "logistic"])
    r.add_argument("--frontend", default=None, metavar="HOST:PORT",
                   help="HELLO this frontend after binding (joins its "
                        "rotation)")
    r.add_argument("--relay-port", type=int, default=None,
                   help="run a relaycast node on this port (0 = "
                        "ephemeral, announced on stdout); absent = "
                        "relay off, classic direct SUBSCRIBE")
    r.add_argument("--relay-parent", default=None, metavar="HOST:PORT",
                   help="planned relay parent's node endpoint; absent "
                        "with --relay-port = a direct child of the PS "
                        "root")
    r.add_argument("--relay-auto", action="store_true",
                   help="derive rid + relay parent from this pod's "
                        "hostname ordinal (StatefulSet convention "
                        "name-<i>) and the k-ary tree plan "
                        "(async.relay.fanout); needs --relay-port and "
                        "--relay-service")
    r.add_argument("--relay-service", default=None, metavar="SVC",
                   help="headless-service DNS suffix for --relay-auto "
                        "peer addressing (name-<i>.SVC:relay-port)")
    r.add_argument("--conf", action="append", default=[], metavar="K=V")
    f = sub.add_parser("frontend", help="replica registry + predict router")
    f.add_argument("--host", default="0.0.0.0")
    f.add_argument("--port", type=int, default=0,
                   help="front-door port (0 = ephemeral, printed on stdout)")
    f.add_argument("--replicas", default="", metavar="H:P,H:P",
                   help="static replica endpoints (dynamic HELLOs add more)")
    f.add_argument("--conf", action="append", default=[], metavar="K=V")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from asyncframework_tpu_torch.cli import (
        parse_conf_overlays,
        resolve_cli_devices,
    )

    parse_conf_overlays(args.conf)
    # the replica's device first: without a card (and without
    # ASYNCTPU_FORCE_CPU) it raises here, before anything binds
    device = resolve_cli_devices(1)[0] if args.role == "replica" else None
    from asyncframework_tpu_torch.net.faults import maybe_install_from_conf

    maybe_install_from_conf()  # chaos fabric reaches serving daemons too
    from asyncframework_tpu_torch.metrics.live import start_telemetry_from_conf

    # per-process telemetry endpoint (async.metrics.port; -1 = off):
    # /metrics Prometheus exposition + /api/status counters/health for
    # the serving fleet -- k8s manifests annotate these pods for scraping
    if args.role == "replica":
        start_telemetry_from_conf("replica",
                                  labels={"rid": str(args.rid)})
    else:
        start_telemetry_from_conf("frontend")
    if args.role == "replica":
        from asyncframework_tpu_torch.serving.replica import serve_replica

        rid, relay_parent = args.rid, args.relay_parent
        if args.relay_auto:
            # StatefulSet convention: hostname "async-serve-replica-3"
            # -> rid 3; the parent is a pure function of (rid, fanout)
            # (relaycast/tree.py), addressed through the headless
            # service -- zero coordination, every pod computes the same
            # tree
            import socket as _socket

            from asyncframework_tpu_torch.conf import RELAY_FANOUT, global_conf
            from asyncframework_tpu_torch.relaycast import ROOT, parent_index

            if args.relay_port is None or not args.relay_service:
                raise SystemExit("--relay-auto needs --relay-port and "
                                 "--relay-service")
            hostname = _socket.gethostname()
            base, _, ordinal = hostname.rpartition("-")
            if not ordinal.isdigit():
                raise SystemExit(f"--relay-auto needs an ordinal "
                                 f"hostname (got {hostname!r})")
            rid = int(ordinal)
            fanout = int(global_conf().get(RELAY_FANOUT))
            p = parent_index(rid, fanout)
            relay_parent = None if p == ROOT else (
                f"{base}-{p}.{args.relay_service}:{args.relay_port}"
            )
        rep = serve_replica(args.ps, rid=rid, host=args.host,
                            port=args.port, loss=args.loss,
                            frontend=args.frontend,
                            relay_port=args.relay_port,
                            relay_parent=relay_parent, device=device)
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            rep.stop()
        return 0
    # frontend role
    from asyncframework_tpu_torch.serving.frontend import ServingFrontend

    replicas = []
    for tok in (args.replicas or "").split(","):
        tok = tok.strip()
        if tok:
            host, port = tok.rsplit(":", 1)
            replicas.append((host, int(port)))
    fe = ServingFrontend(replicas).serve(port=args.port, host=args.host)
    print(json.dumps({"role": "frontend", "port": fe.port,
                      "pid": os.getpid()}), flush=True)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        fe.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
