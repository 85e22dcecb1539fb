"""Multilateration server: N remote modes_rx feeds -> aircraft positions.
The port of `airmodes/apps/modes_mlat.py`, over the port's
`decode/mlat_net`, `io/relay`, `io/netclient`, `outputs/httpd`,
`outputs/tcpserver` and `outputs/sbs1`; it runs no demod, so it takes no
device.

The reference collected mlat-grade observations by running modes_rx with
PPS timestamps at several sites and correlating offline (python/mlat.py
self-test shows the math; python/zmq_socket.py the tcp:// transport).
This app closes the loop online: each remote site runs

    modes_rx -s <sdr/file> --pub tcp://0.0.0.0:PORT

and modes_mlat subscribes to every site, correlates identical frames by
hex within the light-travel window (decode/mlat_net.py), and prints (or
re-publishes) TDOA positions.

    python -m airmodes_torch.apps.modes_mlat \
        -S 47.0,8.0,500@tcp://siteA:5555 \
        -S 47.2,8.1,420@tcp://siteB:5555 \
        -S 46.9,8.3,610@tcp://siteC:5555

A zmq:// feed (a modes_rx --pub address) needs pyzmq, optional as in the
reference; beast://, beastgps:// and avr:// feeds do not.
"""

from __future__ import annotations

import argparse
import queue
import sys
import time
from typing import List, Optional


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="modes_mlat",
        description="TDOA multilateration over remote modes_rx feeds")
    p.add_argument("-S", "--station", action="append", required=True,
                   metavar="LAT,LON,ALT@ADDR",
                   help="station position (deg, deg, meters MSL) and its "
                   "feed address; repeat >= 3 times. ADDR is a modes_rx "
                   "--pub zmq address (tcp://host:port), or a standard "
                   "receiver feed: beastgps://host:port (radarcape-style "
                   "GPS-disciplined timestamps — what cross-station TDOA "
                   "needs), beast://host:port, avr://host:port")
    p.add_argument("--min-stations", type=int, default=3)
    p.add_argument("--window", type=float, default=0.010,
                   help="frame correlation window, seconds [0.010]; "
                   "--clock-sync enforces a 0.05 floor (must cover "
                   "counter-anchor jitter)")
    p.add_argument("--alt-datum", choices=["msl", "ellipsoid"],
                   default="msl")
    p.add_argument("--clock-sync", action="store_true",
                   help="estimate per-station clock offsets from ADS-B "
                   "position frames (the mlat-server technique) so plain "
                   "beast:// receivers with free-running counters can "
                   "TDOA — no GPS discipline needed. Their counters are "
                   "host-anchored per connection; DF17 positions train "
                   "the offsets; other frames solve once converged")
    p.add_argument("--pub", default=None, metavar="ADDR",
                   help="re-publish solutions on a zmq PUB socket "
                   "(topic 'mlat')")
    p.add_argument("-P", "--sbs1", type=int, default=None, metavar="PORT",
                   help="serve solutions as SBS-1/BaseStation MSG,3 CSV "
                   "on this TCP port (Virtual Radar Server etc. display "
                   "mlat tracks directly)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve a live web map + aircraft.json of the "
                   "solved positions on this port")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="exit after this long (testing)")
    p.add_argument("--max-solutions", type=int, default=None,
                   help="exit after solving this many positions (one-shot "
                   "fixes, testing)")
    return p


def parse_station(s: str):
    """'LAT,LON,ALT@URL' -> ((lat, lon, alt), url); raises ValueError
    with a usable message on malformed input (clean CLI error, not a
    traceback — same convention as network URLs below)."""
    pos, sep, addr = s.partition("@")
    if not sep or not addr:
        raise ValueError(f"bad -S/--station {s!r}: expected "
                         "LAT,LON,ALT@URL (e.g. 47.0,8.0,500@beast://h:p)")
    try:
        lat, lon, alt = (float(x) for x in pos.split(","))
    except ValueError:
        raise ValueError(f"bad -S/--station position {pos!r}: expected "
                         "LAT,LON,ALT in decimal degrees / meters")
    return (lat, lon, alt), addr


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    from ..decode.mlat_net import mlat_correlator
    from ..io.relay import zmq_pubsub_iface

    stations, addrs = [], []
    for s in args.station:
        try:
            pos, addr = parse_station(s)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        stations.append(pos)
        addrs.append(addr)
    if args.min_stations < 3:
        # the TDOA solver hard-requires >= 3 stations; a lower setting
        # would run forever silently solving nothing (every group's
        # mlat() raises, swallowed as drop-and-continue)
        print("--min-stations must be >= 3 (TDOA needs 3+ receivers)",
              file=sys.stderr)
        return 2
    if len(stations) < args.min_stations:
        print(f"need >= {args.min_stations} stations", file=sys.stderr)
        return 2

    window = args.window
    if args.clock_sync and window < 0.05:
        # the window must cover the coarse inter-station anchor jitter
        # (~ms over TCP), not just light travel
        print(f"# --clock-sync: raising --window {window} -> 0.05 s "
              "(must cover counter-anchor jitter)", file=sys.stderr)
        window = 0.05
    corr = mlat_correlator(stations, min_stations=args.min_stations,
                           window_s=window, alt_datum=args.alt_datum,
                           clock_sync_enabled=args.clock_sync)
    inbox: "queue.Queue" = queue.Queue()
    relays = []
    for i, addr in enumerate(addrs):
        from ..io.netclient import client_for_url
        # under clock sync, non-GPS feeds must carry counter-derived
        # (host-anchored) timestamps: host receive times have ms TCP
        # jitter, useless for us-level TDOA
        ts_mode = "mlat" if args.clock_sync and \
            not addr.startswith("beastgps://") else None
        if ts_mode == "mlat" and addr.startswith("avr://"):
            print(f"# note: {addr} under --clock-sync needs '@<mlat>' "
                  "AVR records (dump1090 --net-ro MLAT format); plain "
                  "'*hex;' records carry no counter and are dropped",
                  file=sys.stderr)
        try:
            cli = client_for_url(addr, lambda m, i=i: inbox.put((i, m)),
                                 timestamps=ts_mode)
        except ValueError as e:  # typo'd URL: clean CLI error, no traceback
            print(str(e), file=sys.stderr)
            for r in relays:
                r.close()
            return 2
        if cli is not None:  # beast/beastgps/avr receiver feed
            if args.clock_sync:
                # a reconnect / counter reset re-anchors the feed: the
                # trained offset is garbage. Serialize the reset through
                # the inbox so it lands between messages, not mid-update.
                cli.on_reanchor = (lambda i=i: inbox.put((i, None)))
            relays.append(cli.start())
            continue
        r = zmq_pubsub_iface(subaddr=addr)
        r.subscribe("dl_data", lambda m, i=i: inbox.put((i, m)))
        relays.append(r)
    pub = zmq_pubsub_iface(pubaddr=args.pub) if args.pub else None
    web = None
    if args.http is not None:
        from ..outputs.httpd import output_http
        centroid = (sum(s[0] for s in stations) / len(stations),
                    sum(s[1] for s in stations) / len(stations))
        web = output_http(args.http, my_position=centroid)

    def web_update(sol) -> None:
        from ..decode.parse import AircraftReport
        web.update_report(AircraftReport(
            df=0, icao=sol.icao, timestamp=sol.timestamp, ref_dbfs=0.0,
            raw_hex=sol.hexframe, lat=sol.lat, lon=sol.lon,
            altitude_ft=round(sol.alt_m / 0.3048)), trusted=True)
    sbs = None
    if args.sbs1 is not None:
        from ..outputs.tcpserver import broadcast_server
        sbs = broadcast_server(args.sbs1)

    def sbs_line(sol):
        # column layout lives in outputs/sbs1.py (one place to fix)
        from ..outputs.sbs1 import sbs_position_line
        return sbs_position_line(sol.icao, sol.timestamp,
                                 round(sol.alt_m / 0.3048),
                                 sol.lat, sol.lon)

    n_solved = 0
    t_start = time.time()
    t_stats = time.time()
    try:
        while True:
            if args.max_seconds and time.time() - t_start > args.max_seconds:
                break
            if corr.sync is not None and time.time() - t_stats > 10.0:
                t_stats = time.time()
                sy = corr.sync
                rpt = " ".join(
                    f"s{i}:{'anchor' if i == sy.anchor else ''}"
                    f"{'' if i == sy.anchor else f'{sy.offset[i]*1e6:+.1f}us'}"
                    f"{'' if i == sy.anchor or not sy.rate[i] else f'@{sy.rate[i]*1e6:+.2f}ppm'}"
                    f"({min(sy.n_updates[i], 9999)})"
                    for i in range(len(stations)))
                print(f"# clock sync: {rpt}", file=sys.stderr)
            try:
                station, msg = inbox.get(timeout=0.5)
            except queue.Empty:
                continue
            if msg is None:       # feed re-anchored: invalidate its sync
                corr.reset_station(station)
                print(f"# clock sync: station {station} re-anchored, "
                      "offset state reset", file=sys.stderr)
                continue
            for sol in corr.feed(station, msg):
                n_solved += 1
                from ..decode.parse import format_icao
                line = (f"mlat {sol.hexframe} "
                        f"{'' if sol.icao is None else format_icao(sol.icao)} "
                        f"({sol.lat:.5f}, {sol.lon:.5f}) alt {sol.alt_m:.0f} m"
                        f" from {sol.n_stations} stations "
                        f"[{sol.timestamp:.6f}]")
                print(line, flush=True)
                if pub:
                    pub.publish("mlat", line)
                if sbs is not None:
                    lin = sbs_line(sol)
                    if lin is not None:
                        sbs.broadcast((lin + "\r\n").encode())
                if web is not None and sol.icao is not None:
                    web_update(sol)
            if args.max_solutions and n_solved >= args.max_solutions:
                break
    except KeyboardInterrupt:
        pass
    finally:
        for r in relays:
            r.close()
        if pub:
            pub.close()
        if sbs is not None:
            sbs.close()
        if web is not None:
            web.close()
    print(f"# modes_mlat: {n_solved} positions solved", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
