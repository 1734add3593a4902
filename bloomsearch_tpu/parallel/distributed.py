"""Scatter/gather query coordination across peers.

The reference sketches (README.md:397-418, never implemented) a coordinator
that prefilters, scatters work to peers, and streams rows back per query.
Implemented here against a minimal :class:`QueryPeer` protocol —
``BloomSearchEngine`` satisfies it directly, so peers can be local engines
over distinct stores today and remote proxies (same protocol over any RPC)
without coordinator changes. Within one host, the device-native scale-out is
the mesh-sharded probe (mesh.py); this layer is the cross-host seam.

Semantics match the single-engine streaming contract: unordered rows to
``result_queue`` with a single ``None`` completion sentinel once EVERY peer
finishes; per-peer errors forward to ``error_queue`` (that peer stops,
others continue — the reference's per-worker error model); stats forward
lossily.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Protocol, Sequence, runtime_checkable

from ..query import Query


@runtime_checkable
class QueryPeer(Protocol):
    def query(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue] = None,
        stats_queue: Optional[queue.Queue] = None,
    ) -> None: ...


class ScatterGatherCoordinator:
    """Fan a query out to peers and gather streams into one."""

    def __init__(self, peers: Sequence[QueryPeer]):
        if not peers:
            raise ValueError("at least one peer required")
        self.peers = list(peers)

    def query(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue] = None,
        stats_queue: Optional[queue.Queue] = None,
    ) -> None:
        """Scatter; a funnel thread per peer gathers until all complete."""
        done_counter = {"remaining": len(self.peers)}
        lock = threading.Lock()

        def funnel(peer: QueryPeer) -> None:
            peer_results: queue.Queue = queue.Queue()
            try:
                peer.query(q, peer_results, error_queue, stats_queue)
            except Exception as exc:
                from ..engine import try_put

                try_put(error_queue, exc)
                _finish()
                return
            while True:
                item = peer_results.get()
                if item is None:
                    break
                result_queue.put(item)
            _finish()

        def _finish() -> None:
            with lock:
                done_counter["remaining"] -= 1
                if done_counter["remaining"] == 0:
                    result_queue.put(None)

        for peer in self.peers:
            threading.Thread(target=funnel, args=(peer,), daemon=True).start()

    def query_sync(self, q: Optional[Query], timeout: Optional[float] = None) -> list[dict]:
        from ..utils import collect_query_sync

        return collect_query_sync(self.query, q, timeout)
