"""Raw TCP server (ref: gr-air-modes python/raw_server.py output_raw).

Broadcasts the raw hex frame strings to all connected clients — the "feed
another decoder" path. Lines are `*<hex>;` (AVR format) so downstream
dump1090-style consumers can ingest them, plus the framework's native wire
string on request.
"""

from __future__ import annotations

from .tcpserver import broadcast_server


class output_raw:
    def __init__(self, port: int = 9988, host: str = "0.0.0.0",
                 avr_format: bool = True):
        self._avr = avr_format
        self._srv = broadcast_server(port, host)
        self.port = self._srv.port

    def output(self, msg: str) -> None:
        if self._avr:
            parts = msg.split()
            if len(parts) < 2:
                return
            line = f"*{parts[1]};\n"
        else:
            line = msg + "\n"
        self._srv.broadcast(line.encode())

    def close(self) -> None:
        self._srv.close()
