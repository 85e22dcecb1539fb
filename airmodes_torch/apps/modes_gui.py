"""GUI receiver (ref: gr-air-modes apps/modes_gui, PyQt4): the port of
`airmodes/apps/modes_gui.py`.

    python -m airmodes_torch.apps.modes_gui -s cap.c64 [--device cpu]

Live aircraft table + azimuth coverage map + per-aircraft detail, driven by
the same demod pipeline as the port's modes_rx (`build_msg_iter`, on the
card unless `--device cpu`). Backend selection:

  - PyQt5/PySide6 when importable: widget GUI (table via QAbstractTableModel
    wrapper over outputs.gui_model.dashboard, polar az_map painting)
  - otherwise: a curses terminal dashboard (headless-friendly), same models

The data models live in outputs/gui_model.py and outputs/az_map.py and are
fully testable without a display.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

from ..outputs.az_map import az_map_model, output_az_map
from ..outputs.gui_model import COLUMNS, dashboard, output_dashboard
from ..decode.parse import parse
from ..exceptions import ADSBError


def _qt_modules():
    # QtGui must come from the SAME family as QtWidgets: importing PyQt5
    # inside a PySide6 paintEvent raises on every repaint
    try:
        from PyQt5 import QtCore, QtGui, QtWidgets  # type: ignore
        return QtCore, QtWidgets, QtGui
    except ImportError:
        try:
            from PySide6 import QtCore, QtGui, QtWidgets  # type: ignore
            return QtCore, QtWidgets, QtGui
        except ImportError:
            return None


# --------------------------------------------------------------------------
# Qt backend
# --------------------------------------------------------------------------

def run_qt(feed, dash: dashboard, azm: az_map_model) -> int:
    QtCore, QtWidgets, QtGui = _qt_modules()

    class AircraftTable(QtCore.QAbstractTableModel):
        # Qt requires rowCount()/data() to agree within one layout pass;
        # reading the live dashboard from both (feed threads insert/prune
        # concurrently) rendered phantom/blank rows. A locked rows()
        # snapshot, refreshed once per timer tick, is the consistent
        # model Qt expects.
        def __init__(self):
            super().__init__()
            self._rows = []

        def refresh_rows(self):
            self._rows = dash.rows()

        def rowCount(self, parent=None):
            return len(self._rows)

        def columnCount(self, parent=None):
            return len(COLUMNS)

        def headerData(self, i, orient, role):
            if role == QtCore.Qt.DisplayRole and orient == QtCore.Qt.Horizontal:
                return COLUMNS[i]
            return None

        def data(self, index, role):
            if role != QtCore.Qt.DisplayRole:
                return None
            if index.row() >= len(self._rows):
                return None
            v = self._rows[index.row()][index.column()]
            return "" if v is None else str(v)

    class AzMap(QtWidgets.QWidget):
        def paintEvent(self, ev):
            p = QtGui.QPainter(self)
            w, h = self.width(), self.height()
            cx, cy, r = w // 2, h // 2, min(w, h) // 2 - 8
            p.drawEllipse(cx - r, cy - r, 2 * r, 2 * r)
            maxr = max(azm.max_range(), 1.0)
            import math
            pts = []
            for brg, rng in azm.envelope():
                if rng <= 0.0:
                    continue    # uncovered bearing: drawing it collapses
                    # the polygon to the center (render_ascii skips too)
                rr = r * min(rng / maxr, 1.0)
                a = math.radians(brg - 90.0)
                pts.append(QtCore.QPointF(cx + rr * math.cos(a),
                                          cy + rr * math.sin(a)))
            if pts:
                p.drawPolygon(QtGui.QPolygonF(pts))

    app = QtWidgets.QApplication(sys.argv)
    win = QtWidgets.QMainWindow()
    win.setWindowTitle("airmodes — Mode S live")
    split = QtWidgets.QSplitter()
    table_model = AircraftTable()
    view = QtWidgets.QTableView()
    view.setModel(table_model)
    split.addWidget(view)
    split.addWidget(AzMap())
    win.setCentralWidget(split)
    win.resize(1100, 500)
    win.show()

    timer = QtCore.QTimer()

    def refresh():
        dash.prune()
        table_model.refresh_rows()
        table_model.layoutChanged.emit()
        split.widget(1).update()
    timer.timeout.connect(refresh)
    timer.start(1000)

    stop = threading.Event()
    t = threading.Thread(target=lambda: feed(stop), daemon=True)
    t.start()
    try:
        # PySide6 6.x removed the snake_case exec_(); PyQt5 has both
        run = getattr(app, "exec", None) or app.exec_
        return run()
    finally:
        stop.set()


# --------------------------------------------------------------------------
# curses backend (headless terminals)
# --------------------------------------------------------------------------

def run_curses(feed, dash: dashboard, azm: az_map_model,
               max_seconds: Optional[float] = None) -> int:
    import curses

    stop = threading.Event()

    show_map = [False]

    def ui(scr):
        curses.use_default_colors()
        scr.nodelay(True)
        t0 = time.time()
        while not stop.is_set():
            if max_seconds and time.time() - t0 > max_seconds:
                break
            try:
                ch = scr.getch()
                if ch in (ord("q"), 27):
                    break
                if ch == ord("m"):
                    show_map[0] = not show_map[0]
            except curses.error:
                pass
            scr.erase()
            rows = dash.rows()
            if show_map[0]:
                # coverage diagram (the curses twin of the Qt az_map)
                from ..outputs.az_map import render_ascii
                maxy, maxx = scr.getmaxyx()
                scr.addstr(0, 0, ("airmodes coverage — max range per "
                                  "bearing (m: table, q: quit)")[: maxx - 1],
                           curses.A_BOLD)
                live = [(r[10], r[9], (r[1] or r[0]))
                        for r in rows if r[9] is not None]  # brg, rng, id
                art = render_ascii(azm, width=min(maxx - 1, 101),
                                   height=maxy - 3, aircraft=live)
                for i, line in enumerate(art[: maxy - 2]):
                    scr.addstr(2 + i, 0, line[: maxx - 1])
                scr.refresh()
                dash.prune()
                time.sleep(0.5)
                continue
            maxy, maxx = scr.getmaxyx()
            scr.addstr(0, 0, (f"airmodes live — {len(rows)} aircraft "
                              f"(m: coverage map, q: quit)")[: maxx - 1],
                       curses.A_BOLD)
            hdr = (f"{'icao':7s}{'ident':9s}{'sqk':5s}{'alt':>7s}{'spd':>5s}"
                   f"{'hdg':>5s}{'vs':>7s}{'lat':>10s}{'lon':>11s}"
                   f"{'rng':>7s}{'brg':>5s}{'dBFS':>7s}  emergency")
            # slice like the data rows: the 96-char header otherwise
            # wraps over row 3 on an 80-column terminal (or aborts the
            # UI entirely on a window too short for the wrapped line)
            scr.addstr(2, 0, hdr[: maxx - 1], curses.A_UNDERLINE)
            # max(0, ...): on a terminal shorter than 4 lines a negative
            # slice keeps rows and addstr past the bottom aborts the UI
            for i, r in enumerate(rows[: max(0, maxy - 4)]):
                (icao, ident, sqk, alt, spd, hdg, vs, lat, lon, rng, brg,
                 emerg, rssi, _) = r
                def s(v, fmt="{}"):
                    return "" if v is None else fmt.format(v)
                line = (f"{icao:7s}{(ident or ''):9s}{s(sqk,'{:04d}'):5s}"
                        f"{s(alt):>7s}{s(spd,'{:.0f}'):>5s}{s(hdg,'{:.0f}'):>5s}"
                        f"{s(vs,'{:+.0f}'):>7s}{s(lat,'{:.4f}'):>10s}"
                        f"{s(lon,'{:.4f}'):>11s}{s(rng,'{:.1f}'):>7s}"
                        f"{s(brg,'{:.0f}'):>5s}{s(rssi,'{:.1f}'):>7s}"
                        f"{'  ' + emerg.upper() if emerg else ''}")
                scr.addstr(3 + i, 0, line[: maxx - 1],
                           curses.A_BOLD if emerg else curses.A_NORMAL)
            scr.refresh()
            dash.prune()
            time.sleep(0.5)

    t = threading.Thread(target=lambda: feed(stop), daemon=True)
    t.start()
    try:
        import curses
        curses.wrapper(ui)
    except curses.error as e:
        # no usable terminal (headless/dumb TERM): degrade to a plain
        # summary instead of dying with a curses traceback. Let the feed
        # run first (a net feed collects for the whole run; a DSP
        # feed finishes its file), THEN stop it and print what arrived.
        print(f"curses UI unavailable ({e}); falling back to a plain "
              "summary — use modes_rx for full console output",
              file=sys.stderr)
        t.join(timeout=max_seconds or 60.0)
        stop.set()
        t.join(timeout=5.0)
        for row in dash.rows():
            print(" ".join("" if v is None else str(v) for v in row))
        return 0
    finally:
        stop.set()
    return 0


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    from .modes_rx import build_argparser, parse_location
    ap = build_argparser()
    ap.prog = "modes_gui"
    ap.add_argument("--backend", choices=["auto", "qt", "curses"],
                    default="auto")
    ap.add_argument("--duration", type=float, default=None,
                    help="auto-exit after N seconds (curses backend)")
    args = ap.parse_args(argv)

    try:
        loc = parse_location(args.location)
    except ValueError as e:     # typo'd -l: clean CLI error, no traceback
        print(str(e), file=sys.stderr)
        return 2
    my_pos = (loc[0], loc[1]) if loc else None
    shared = parse(my_pos, cpr_global_first=args.cpr_global_first)
    dash_plugin = output_dashboard(parser=shared)
    az_plugin = output_az_map(parser=shared, my_position=my_pos)

    # the GUI drives one channel; -s may be repeated only in modes_rx
    srcs = args.source or ["synthetic"]
    if len(srcs) > 1:
        print("modes_gui takes a single source", file=sys.stderr)
        return 2
    source = srcs[0]
    if "://" in source:
        from ..io.netclient import parse_net_url
        try:  # a typo'd URL should fail here, not inside the feed thread
            if parse_net_url(source) is None:
                print(f"unsupported source scheme: {source!r}",
                      file=sys.stderr)
                return 2
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    if source in ("uhd", "osmocom"):
        # same clean error modes_rx prints: falling through to
        # file_source('uhd') would FileNotFoundError inside the daemon
        # feed thread and show an empty UI forever
        print(f"SDR source '{source}' needs UHD/osmosdr hardware drivers "
              "(unavailable); use a recorded file or udp", file=sys.stderr)
        return 2
    if source not in ("udp", "synthetic") and "://" not in source:
        import os
        if not os.path.exists(source):
            print(f"no such capture file: {source}", file=sys.stderr)
            return 2
    frame_replay = args.file_format in ("beast", "beastgps", "avr")
    if frame_replay and (source in ("udp", "synthetic") or "://" in source):
        # same contract as modes_rx: frame replay takes exactly one file
        # (for a live network feed use -s beast://host:port)
        print("frame-recording replay takes a file source (for a live "
              "network feed use -s beast://host:port without "
              "--file-format)", file=sys.stderr)
        return 2
    if source == "udp" and args.file_format != "complex64":
        # same guard as build_msg_iter, but EAGER: raised inside the
        # feed thread it prints under an active curses screen and the
        # user sees a blank table forever
        print("-s udp takes complex64 datagrams; --file-format sc16/uc8 "
              "applies to file sources", file=sys.stderr)
        return 2
    needs_resample = abs(args.rate - args.channel_rate) > 1e-3
    if needs_resample and not frame_replay and (
            source in ("udp", "synthetic") or "://" in source):
        print("resampling is only wired for file sources", file=sys.stderr)
        return 2
    if not frame_replay and "://" not in source:
        # the demod's device, before the UI starts: without a card,
        # --device cuda is a clean CLI error, as in modes_rx
        from ..dsp.pipeline import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2

    def emit(m: str) -> None:
        # parse ONCE through the shared stateful parser (CPR/ELM state
        # must see each frame exactly once; double-parsing also halves
        # the 55k msg/s host parse ceiling), then feed both models
        try:
            rep = shared.parse(m)
        except ADSBError:
            return
        dash_plugin.model.update(rep)
        az_plugin.update(rep)

    def feed(stop: threading.Event):
        from ..io.netclient import client_for_url
        cli = client_for_url(source, emit)
        if cli is not None:  # remote receiver feed: no DSP in this process
            cli.start()
            try:
                # the client delivers from its own thread; this feed
                # thread just holds the connection open until the UI stops
                stop.wait()
            finally:
                cli.close()
            return
        if frame_replay:
            # recorded Beast/AVR frames: decode stack only, no DSP
            # (mirrors modes_rx._run_frame_replay)
            from ..io.netclient import replay_file
            fmt = "beast" if args.file_format == "beastgps" \
                else args.file_format
            t0 = time.time()
            for wire_msg, off in replay_file(
                    source, fmt=fmt,
                    gps_time=args.file_format == "beastgps"):
                if stop.is_set():
                    return
                if args.throttle:
                    ahead = off - (time.time() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
                emit(wire_msg)
            return
        from ..config import DspConfig
        from .modes_rx import build_msg_iter
        cfg = DspConfig(channel_rate=args.channel_rate,
                        threshold_db=args.threshold,
                        block_size=args.block_size,
                        max_detections=args.max_detections)
        # the SAME source->pipeline dispatch as modes_rx (native C++
        # runtime, fused resample, python sources): a hand-simplified
        # copy would drift from it (skip the native path, ignore
        # --no-native/--i8-scale)
        args.source = source
        if source == "synthetic" and not args.max_blocks:
            args.max_blocks = 64     # GUI demo default (modes_rx uses 4)
        try:
            msg_iter = build_msg_iter(args, cfg, epoch=time.time())
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return
        for msgs in msg_iter:
            if stop.is_set():
                return
            for m in msgs:
                emit(m)
            if args.throttle:
                time.sleep(cfg.block_size / cfg.channel_rate)

    backend = args.backend
    if backend == "auto":
        backend = "qt" if _qt_modules() else "curses"
    if backend == "qt":
        if not _qt_modules():
            print("PyQt5/PySide6 not installed; use --backend curses",
                  file=sys.stderr)
            return 2
        return run_qt(feed, dash_plugin.model, az_plugin.model)
    return run_curses(feed, dash_plugin.model, az_plugin.model,
                      max_seconds=args.duration)


if __name__ == "__main__":
    sys.exit(main())
