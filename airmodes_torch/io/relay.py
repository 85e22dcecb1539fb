"""Message relays: the in-process `local_pubsub` and the ZeroMQ PUB/SUB
bridge `zmq_pubsub_iface` of `airmodes/io/relay.py`.

`zmq_pubsub_iface(context, subaddr, pubaddr)` is a bridge thread that
forwards zmq SUB traffic to local subscriber callbacks and local publishes
out a zmq PUB socket: it feeds decoders on other machines (`modes_rx --pub
tcp://...`, `modes_mlat`). pyzmq is optional, as in the reference: without
it `HAVE_ZMQ` is False, `local_pubsub` still works and the bridge raises.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

try:
    import zmq
    HAVE_ZMQ = True
except ImportError:  # pragma: no cover
    zmq = None
    HAVE_ZMQ = False

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
                continue  # drop-and-continue per subscriber, matching
                # zmq_pubsub_iface._dispatch: a raising subscriber must not
                # kill the publishing demod loop or starve later subscribers

    def close(self) -> None:
        pass


class zmq_pubsub_iface:
    """Bridge thread between a zmq SUB socket and local callbacks, plus a
    local-publish -> zmq PUB path (mirrors the reference API:
    subscribe(topic, callback) / publish(topic, msg) / close()).

    Local callback fan-out composes a `local_pubsub` (one drop-and-
    continue contract, not a copy). SUB-side topic filtering is pushed
    into zmq (per-topic SUBSCRIBE applied by the bridge thread — zmq
    sockets are single-threaded) so unwanted topics are dropped at the
    PUBLISHER, not shipped over TCP and filtered here: with per-channel
    'dl_data/chN' duplicates this halves the wire traffic or better."""

    def __init__(self, context=None, subaddr: Optional[str] = None,
                 pubaddr: Optional[str] = None):
        if not HAVE_ZMQ:
            raise RuntimeError("pyzmq not available; use local_pubsub")
        self._ctx = context or zmq.Context.instance()
        self._subaddr = subaddr
        self._pubaddr = pubaddr
        self._local = local_pubsub()
        self._stop = threading.Event()
        self._closed = threading.Event()
        # set by the bridge thread if it exits on an unrecoverable socket
        # error: publish() then falls back to local dispatch so local
        # subscribers keep working
        self._bridge_dead = threading.Event()
        # (subscribe?, topic) ops the bridge thread has yet to apply —
        # zmq sockets are single-threaded, so SUBSCRIBE *and* UNSUBSCRIBE
        # both queue here
        self._pending_topics: List[Tuple[bool, str]] = []
        self._pending_lock = threading.Lock()

        self._pub = None
        if pubaddr:
            self._pub = self._ctx.socket(zmq.PUB)
            self._pub.bind(pubaddr)
            self._pub_lock = threading.Lock()

        self._thread = None
        if subaddr:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def subscribe(self, topic: str, callback: Callable[[str], None]) -> None:
        self._local.subscribe(topic, callback)
        with self._pending_lock:
            self._pending_topics.append((True, topic))

    def unsubscribe(self, topic: str, callback) -> None:
        self._local.unsubscribe(topic, callback)
        # release the matching zmq-side subscription too: zmq refcounts
        # filter entries, so pairing one UNSUBSCRIBE per subscribe()
        # balances exactly — without it the publisher keeps shipping the
        # topic over TCP forever (dropped-at-publisher is this class's
        # whole point) and repeated cycles stack dead filter entries
        with self._pending_lock:
            self._pending_topics.append((False, topic))

    def publish(self, topic: str, msg: str) -> None:
        if self._closed.is_set():
            return        # post-close publishes DROP (falling through to
            # local dispatch would deliver messages after close)
        if self._pub is not None:
            with self._pub_lock:
                if self._pub is not None:   # close() raced us: drop
                    self._pub.send_multipart([topic.encode(), msg.encode()])
            if self._thread is None or self._bridge_dead.is_set():
                # pubaddr-only iface (or the SUB bridge died on a socket
                # error): local subscribers would otherwise NEVER fire —
                # dispatch locally too. With a live bridge, the loopback
                # delivers, so skip to avoid double dispatch.
                self._local.publish(topic, msg)
        else:
            # no PUB socket: dispatch locally (inproc short-circuit)
            self._local.publish(topic, msg)

    def _dispatch(self, topic: str, msg: str) -> None:
        self._local.publish(topic, msg)

    def _run(self) -> None:
        import sys
        sub = None
        try:
            sub = self._ctx.socket(zmq.SUB)
            sub.connect(self._subaddr)
            poller = zmq.Poller()
            poller.register(sub, zmq.POLLIN)
            errors = 0
            while not self._stop.is_set():
                with self._pending_lock:
                    pending, self._pending_topics = self._pending_topics, []
                try:
                    # setsockopt INSIDE the guarded region: an ETERM /
                    # EINVAL here would kill the thread with an
                    # unhandled traceback and leak the socket
                    for is_sub, t in pending:
                        sub.setsockopt(
                            zmq.SUBSCRIBE if is_sub else zmq.UNSUBSCRIBE,
                            t.encode())
                    if not dict(poller.poll(timeout=100)):
                        continue
                    parts = sub.recv_multipart()
                    errors = 0
                except zmq.ZMQError as e:
                    if self._stop.is_set():
                        break
                    if getattr(e, "errno", None) == zmq.ETERM:
                        print("zmq_pubsub_iface: context terminated",
                              file=sys.stderr)
                        break
                    # transient error: log and RETRY (a permanent break
                    # would silently starve every subscriber); give up
                    # only after a burst of consecutive failures
                    errors += 1
                    print(f"zmq_pubsub_iface: recv error ({errors}): {e}",
                          file=sys.stderr)
                    if errors >= 10:
                        break
                    self._stop.wait(0.2)
                    continue
                if len(parts) == 2:
                    self._dispatch(parts[0].decode(), parts[1].decode())
        except zmq.ZMQError as e:
            print(f"zmq_pubsub_iface: SUB setup failed for "
                  f"{self._subaddr!r}: {e}", file=sys.stderr)
        finally:
            if not self._stop.is_set():
                self._bridge_dead.set()
            if sub is not None:
                try:
                    sub.close(linger=0)
                except zmq.ZMQError:
                    pass

    def close(self) -> None:
        self._closed.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._pub is not None:
            # under the send lock: a publisher mid-send on a closing zmq
            # socket is undefined behavior in libzmq
            with self._pub_lock:
                pub, self._pub = self._pub, None
                pub.close(linger=0)
