"""Serve a dataset's query path over TCP: ``python -m bloomsearch_tpu.serve``.

Wraps a read-mostly engine behind a :class:`parallel.remote.QueryServer`
and (optionally) announces it in a shared peer registry so coordinators
discover it (parallel/discovery.py). The minimal deployable unit of the
scatter/gather story:

    # peer A and B, one shared dataset on a shared filesystem; each server
    # process takes its own card
    CUDA_VISIBLE_DEVICES=0 python -m bloomsearch_tpu.serve \\
        --object-dir /mnt/bucket --port 7801 --registry --peer-id a --capacity 2
    CUDA_VISIBLE_DEVICES=1 python -m bloomsearch_tpu.serve \\
        --object-dir /mnt/bucket --port 7802 --registry --peer-id b

    # coordinator
    from bloomsearch_tpu import LocalDirObjectStore, ObjectStoreMetaStore
    from bloomsearch_tpu.parallel import CapacityScatterCoordinator, PeerRegistry
    client = LocalDirObjectStore("/mnt/bucket")
    coord = CapacityScatterCoordinator(ObjectStoreMetaStore(client), PeerRegistry(client))
    rows = coord.query_sync(query)

``--dir`` serves a plain FileSystemDataStore dataset instead (no registry —
peers then get listed explicitly via RemoteQueryPeer addresses).

One server process per card: JAX reserves most of a card's memory when a
process first uses it, so two servers on one host must each see a different
card (``CUDA_VISIBLE_DEVICES``); a second process on the same card fails for
want of memory.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from .engine import BloomSearchEngine, BloomSearchEngineConfig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu.serve")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--dir", help="FileSystemDataStore dataset directory")
    src.add_argument(
        "--object-dir", help="LocalDirObjectStore bucket directory (shared fs)"
    )
    # The query protocol has no auth or encryption (trusted networks only) —
    # binding beyond loopback must be an explicit operator decision.
    parser.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (default loopback; the protocol is unauthenticated "
        "— pass an external address only on a trusted network)",
    )
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--probe-backend", default="auto")
    parser.add_argument(
        "--row-cache-mb", type=int, default=0,
        help="serving mode: pin hot rows in HBM (0 = off)",
    )
    parser.add_argument(
        "--registry", action="store_true",
        help="announce in the object store's peer registry (--object-dir only)",
    )
    parser.add_argument("--peer-id", default=None)
    parser.add_argument("--capacity", type=float, default=1.0)
    parser.add_argument(
        "--advertise-host", default=None,
        help="address peers should dial (default: --host)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")

    if args.dir:
        from .stores import FileSystemDataStore

        store = FileSystemDataStore(args.dir)
        meta_store = data_store = store
        client = None
    else:
        from .objectstore import (
            LocalDirObjectStore,
            ObjectStoreDataStore,
            ObjectStoreMetaStore,
        )

        client = LocalDirObjectStore(args.object_dir)
        meta_store = ObjectStoreMetaStore(client)
        data_store = ObjectStoreDataStore(client)

    config = BloomSearchEngineConfig(
        probe_backend=args.probe_backend,
        row_cache_bytes=args.row_cache_mb << 20,
    )
    engine = BloomSearchEngine(config, meta_store, data_store)
    engine.start()

    from .parallel.remote import QueryServer

    server = QueryServer(engine, host=args.host, port=args.port)
    server.start()
    print(f"serving queries on {server.host}:{server.port}", flush=True)

    heartbeat = None
    if args.registry:
        if client is None:
            parser.error("--registry requires --object-dir")
        from .parallel.discovery import PeerRegistry

        peer_id = args.peer_id or f"{server.host}:{server.port}"
        registry = PeerRegistry(client)
        heartbeat = registry.heartbeat(
            peer_id, args.advertise_host or server.host, server.port,
            capacity=args.capacity,
        )
        print(f"announced as peer {peer_id!r} (capacity {args.capacity})", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    print("shutting down", flush=True)
    if heartbeat is not None:
        heartbeat.stop()
    server.stop()
    engine.stop(timeout=60)


if __name__ == "__main__":
    main()
