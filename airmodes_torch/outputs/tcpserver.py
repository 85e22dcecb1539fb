"""Shared nonblocking TCP broadcast server for output plugins.

The reference repeats the accept/broadcast/drop-dead-client pattern in each
server plugin (python/sbs1.py, python/raw_server.py); here it is one class.
Semantics preserved from those plugins: nonblocking accept folded into the
send path, bounded (1 s timeout) sends so a stalled client cannot block the
decode loop, and drop-and-continue on any client error (SURVEY.md §5.3).

Hardening: sends happen OUTSIDE the client-list lock on a
snapshot (the lock-held form made stalls additive across clients and
blocked close()/accept for the duration); a closed flag stops a racing
accept from appending — and leaking — a client after close() cleared the
list; an acceptor can be polled explicitly (`poll()`) so clients
connecting during message silence don't rot in the listen backlog.
"""

from __future__ import annotations

import socket
import threading
from typing import List


class broadcast_server:
    """TCP server broadcasting byte payloads to every connected client."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self._srv.setblocking(False)
        self.port = self._srv.getsockname()[1]

    def _accept(self) -> None:
        while True:
            try:
                c, _ = self._srv.accept()
            except (BlockingIOError, OSError):
                return
            # bounded send: a client that stops reading must not stall the
            # decode loop (output() runs synchronously per message) — on
            # timeout the client is dropped, honoring drop-and-continue
            c.settimeout(1.0)
            with self._lock:
                if self._closed:
                    # close() raced us after accept(): the socket would
                    # otherwise leak open-but-never-serviced
                    try:
                        c.close()
                    except OSError:
                        pass
                    return
                self._clients.append(c)

    def poll(self) -> None:
        """Accept pending connections without broadcasting — call from an
        idle tick so clients connecting during message silence are served
        instead of sitting in the listen backlog."""
        self._accept()

    def broadcast(self, data: bytes) -> None:
        self._accept()
        with self._lock:
            snapshot = list(self._clients)
        # send OUTSIDE the lock: each stalled client costs up to its own
        # 1 s timeout, but close()/accept stay unblocked and the total is
        # not serialized behind the lock
        dead = []
        for c in snapshot:
            try:
                c.sendall(data)
            except (socket.timeout, OSError):
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    if c in self._clients:
                        self._clients.remove(c)
            for c in dead:
                try:
                    c.close()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            clients = list(self._clients)
            self._clients.clear()
        for c in clients:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()
