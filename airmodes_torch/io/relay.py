"""In-process message relay: the `local_pubsub` of `airmodes/io/relay.py`.

The reference's `zmq_pubsub_iface` (a ZeroMQ PUB/SUB bridge) is not part of
the port: it needs pyzmq, and the port imports torch, numpy and the
standard library only. `modes_rx --pub` refuses with a clear error.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List


class local_pubsub:
    """Minimal in-process pub/sub: subscribe(topic, callback),
    publish(topic, msg), close()."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[str], None]]] = defaultdict(list)
        self._lock = threading.Lock()

    def subscribe(self, topic: str, callback: Callable[[str], None]) -> None:
        with self._lock:
            self._subs[topic].append(callback)

    def unsubscribe(self, topic: str, callback) -> None:
        with self._lock:
            if callback in self._subs.get(topic, []):
                self._subs[topic].remove(callback)

    def publish(self, topic: str, msg: str) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for cb in subs:
            try:
                cb(msg)
            except Exception:
                continue  # drop-and-continue per subscriber: a raising
                # subscriber must not kill the publishing demod loop or
                # starve later subscribers

    def close(self) -> None:
        pass
