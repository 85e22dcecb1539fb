"""Embedded HTTP server: live map + aircraft.json endpoint (beyond reference).

`modes_rx --http PORT` serves a dump1090-compatible data API plus a
self-contained web UI (no external tile servers — a plan-position canvas
with range rings centered on the receiver, like the reference's az_map
coverage plot, plus a live aircraft table):

    /                       single-file HTML/JS map + table, 1 s refresh
                            (position trails accumulate client-side)
    /data/aircraft.json     dump1090-style snapshot (same doc as -j)
    /data/receiver.json     receiver metadata (lat/lon/refresh interval)
    /data/stats.json        receive statistics: per-DF counts, corrected/
                            total, message rate, unique aircraft
    /data/coverage.json     az-map envelope (max range per bearing) —
                            drawn as a faint polygon under the traffic

State updates ride the plugin's synchronous output() path; HTTP requests
are served from a pre-serialized snapshot under a lock, so slow/many web
clients never block the decode loop.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Optional, Tuple

from ..constants import (AP_ADDRESS_DFS, STATUS_CORRECTED_1,
                         STATUS_CORRECTED_2)
from ..decode.parse import parse
from ..exceptions import ADSBError
from .az_map import az_map_model
from .gui_model import dashboard
from .json_out import build_doc

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>airmodes</title><style>
 body{margin:0;font:13px/1.4 system-ui,sans-serif;background:#14181d;color:#d5dae0;display:flex;height:100vh}
 #map{flex:1 1 60%;min-width:300px}
 #side{flex:1 1 40%;overflow:auto;border-left:1px solid #2a313a;padding:8px}
 table{border-collapse:collapse;width:100%}
 th,td{padding:2px 6px;text-align:right;border-bottom:1px solid #222a33}
 th{color:#8fa3b8;text-transform:uppercase;font-size:11px;position:sticky;top:0;background:#14181d}
 td:first-child,th:first-child{text-align:left}
 .emerg{color:#ff5c5c;font-weight:bold}
 #hdr{color:#8fa3b8;margin:0 0 6px}
</style></head><body>
<canvas id="map"></canvas>
<div id="side"><p id="hdr"></p><table><thead><tr>
<th>hex</th><th>flight</th><th>squawk</th><th>alt ft</th><th>gs kt</th>
<th>trk</th><th>vr fpm</th><th>rng NM</th><th>brg</th><th>rssi</th>
<th>msgs</th><th>seen</th>
</tr></thead><tbody id="rows"></tbody></table></div>
<script>
const cv=document.getElementById('map'),cx=cv.getContext('2d');
let rx=null, ringNm=50;
const trails=new Map(); // hex -> [[lat,lon],...], capped
function noteTrail(a){
  if(a.lat===undefined)return;
  let t=trails.get(a.hex);
  if(!t)trails.set(a.hex,t=[]);
  const last=t[t.length-1];
  if(!last||last[0]!==a.lat||last[1]!==a.lon)t.push([a.lat,a.lon]);
  if(t.length>300)t.shift();
}
function resize(){cv.width=cv.clientWidth;cv.height=cv.clientHeight}
window.addEventListener('resize',resize);
function project(lat,lon){ // local equirectangular around the receiver
  const R=60*ringNm*4; // view spans 4 range rings
  const dx=(lon-rx.lon)*60*Math.cos(rx.lat*Math.PI/180);
  const dy=(lat-rx.lat)*60; // NM north
  const s=Math.min(cv.width,cv.height)/2/(ringNm*4);
  return [cv.width/2+dx*s, cv.height/2-dy*s];
}
let coverage=null;
function drawCoverage(){
  if(!coverage||!rx||!coverage.max_range_nm)return;
  const s=Math.min(cv.width,cv.height)/2/(ringNm*4);
  cx.fillStyle='rgba(88,176,240,0.07)';cx.strokeStyle='rgba(88,176,240,0.25)';
  cx.beginPath();
  coverage.envelope.forEach((p,i)=>{
    const th=p[0]*Math.PI/180, r=p[1]*s;
    const x=cv.width/2+Math.sin(th)*r, y=cv.height/2-Math.cos(th)*r;
    i?cx.lineTo(x,y):cx.moveTo(x,y);
  });
  cx.closePath();cx.fill();cx.stroke();
}
function draw(ac){
  resize();cx.clearRect(0,0,cv.width,cv.height);
  drawCoverage();
  cx.strokeStyle='#2a313a';cx.fillStyle='#8fa3b8';cx.font='10px sans-serif';
  if(rx&&rx.lat!==undefined){
    const s=Math.min(cv.width,cv.height)/2/(ringNm*4);
    for(let r=ringNm;r<=ringNm*4;r+=ringNm){
      cx.beginPath();cx.arc(cv.width/2,cv.height/2,r*s,0,7);cx.stroke();
      cx.fillText(r+' NM',cv.width/2+3,cv.height/2-r*s-3);
    }
    cx.beginPath();cx.arc(cv.width/2,cv.height/2,3,0,7);cx.fill();
  }
  for(const a of ac){
    if(a.lat===undefined||!rx||rx.lat===undefined)continue;
    const tr=trails.get(a.hex)||[];
    if(tr.length>1){ // position trail accumulated client-side
      cx.strokeStyle='#2f6a94';cx.beginPath();
      tr.forEach((p,i)=>{const[tx,ty]=project(p[0],p[1]);
        i?cx.lineTo(tx,ty):cx.moveTo(tx,ty)});
      cx.stroke();
    }
    const[x,y]=project(a.lat,a.lon);
    cx.save();cx.translate(x,y);
    cx.fillStyle=a.emergency&&a.emergency!=='none'?'#ff5c5c':'#58b0f0';
    cx.rotate((a.track||0)*Math.PI/180);
    cx.beginPath();cx.moveTo(0,-6);cx.lineTo(4,6);cx.lineTo(-4,6);cx.closePath();cx.fill();
    cx.rotate(-(a.track||0)*Math.PI/180);
    cx.fillStyle='#d5dae0';cx.fillText(a.flight||a.hex,6,3);cx.restore();
  }
}
let covTick=0;
async function tick(){
  try{
    if(!rx){const r=await fetch('data/receiver.json');rx=await r.json();}
    if(covTick++%10===0){ // coverage changes slowly: refresh every 10 s
      const r=await fetch('data/coverage.json');coverage=await r.json();
    }
    const r=await fetch('data/aircraft.json');const d=await r.json();
    document.getElementById('hdr').textContent=
      d.aircraft.length+' aircraft — updated '+new Date(d.now*1000).toLocaleTimeString();
    const tb=document.getElementById('rows');tb.innerHTML='';
    for(const a of d.aircraft)noteTrail(a);
    // drop trails of aircraft no longer reported: a long-lived tab must
    // not accumulate dead trail arrays without bound
    const live=new Set(d.aircraft.map(a=>a.hex));
    for(const h of[...trails.keys()])if(!live.has(h))trails.delete(h);
    for(const a of d.aircraft){
      const tr=document.createElement('tr');
      if(a.emergency&&a.emergency!=='none')tr.className='emerg';
      let rng='',brg='';
      if(rx&&rx.lat!==undefined&&a.lat!==undefined){
        const dx=(a.lon-rx.lon)*60*Math.cos(rx.lat*Math.PI/180);
        const dy=(a.lat-rx.lat)*60;
        rng=Math.hypot(dx,dy).toFixed(1);
        brg=((Math.atan2(dx,dy)*180/Math.PI+360)%360).toFixed(0);
      }
      for(const v of [a.hex,a.flight,a.squawk,a.alt_baro??a.alt_geom,a.gs&&a.gs.toFixed(0),
                      a.track&&a.track.toFixed(0),a.baro_rate,rng,brg,a.rssi,
                      a.messages,a.seen]){
        const td=document.createElement('td');td.textContent=v===undefined?'':v;tr.appendChild(td);
      }
      tb.appendChild(tr);
    }
    draw(d.aircraft);
  }catch(e){}
  setTimeout(tick,1000);
}
tick();
</script></body></html>
"""


class output_http:
    """Plugin: call output(msg) per raw wire message; serves HTTP forever."""

    def __init__(self, port: int = 8080, parser: Optional[parse] = None,
                 my_position: Optional[Tuple[float, float]] = None,
                 host: str = "0.0.0.0", stale_s: float = 60.0,
                 block_stats=None):
        # a default parser knows the receiver position so range/bearing
        # (and thus the coverage endpoint) work out of the box
        # block_stats: an optional dsp.host.BlockStats shared with the
        # demod loop — surfaces pipeline counters (incl. the native ring's
        # real-time overrun gauge) on /data/stats.json
        self._block_stats = block_stats
        self._parser = parser or parse(my_position)
        self._dash = dashboard(stale_s=stale_s)
        self._lock = threading.Lock()
        self._snapshot = json.dumps({"now": 0, "aircraft": []}).encode()
        rx = {"lat": my_position[0], "lon": my_position[1],
              "refresh": 1000, "version": "airmodes"} if my_position else \
             {"refresh": 1000, "version": "airmodes"}
        self._receiver = json.dumps(rx).encode()
        self._azm = az_map_model()
        self._n_messages = 0
        self._n_bad = 0
        self._n_corrected = 0
        self._n_positions = 0
        self._df_counts: dict = {}
        self._seen_icaos: set = set()
        self._t_first = None
        self._t_latest = None

        plugin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path in ("/", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
                elif path == "/data/aircraft.json":
                    body = plugin.aircraft_doc()
                    ctype = "application/json"
                elif path == "/data/receiver.json":
                    body, ctype = plugin._receiver, "application/json"
                elif path == "/data/stats.json":
                    body = json.dumps(plugin.stats_doc()).encode()
                    ctype = "application/json"
                elif path == "/data/coverage.json":
                    with plugin._lock:
                        env = plugin._azm.envelope()
                        doc = {"envelope": [[round(b, 1), round(r, 1)]
                                            for b, r in env],
                               "max_range_nm":
                               round(plugin._azm.max_range(), 1)}
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: stdout belongs to msprint
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        # attribute init BEFORE the server thread starts: a GET accepted
        # in the gap hit AttributeError in aircraft_doc
        self._last_snap: Optional[float] = None
        self._last_snap_wall: Optional[float] = None
        self._last_doc_wall: float = 0.0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def aircraft_doc(self) -> bytes:
        """Snapshot bytes for GET, re-serialized when the message stream
        has gone quiet so 'seen' ages advance.

        Stream timestamps may be capture time (file replay) or lag wall
        clock (long first compile), so the quiet-gap rebuild extrapolates
        stream time by the wall time elapsed since the last update_report
        snapshot WITHOUT pruning or advancing the stream anchor: the
        extrapolation is a display estimate, and destructively pruning
        (or moving _last_snap ahead of the real stream) from it would
        delete actively-tracked aircraft whenever stream time runs behind
        wall time. Clients filter by the growing 'seen' field, dump1090
        style; real pruning happens on stream-time snapshots."""
        import time as _time
        wall = _time.time()
        with self._lock:
            if self._last_snap is None or self._last_snap_wall is None \
                    or wall - self._last_snap_wall < 1.0 \
                    or wall - self._last_doc_wall < 1.0:
                return self._snapshot
            now = self._last_snap + (wall - self._last_snap_wall)
            self._last_doc_wall = wall    # rate-limit client-driven
            # rebuilds to one per second across all polling clients
            self._snapshot = json.dumps(
                build_doc(self._dash, now, prune=False)).encode()
            return self._snapshot

    def stats_doc(self) -> dict:
        with self._lock:
            counts = dict(self._df_counts)
            doc = {
                "messages": self._n_messages,
                "undecodable": self._n_bad,
                "corrected": self._n_corrected,
                "positions": self._n_positions,
                "by_df": counts,
                "unique_aircraft": len(self._seen_icaos),
                "gated_phantoms": self._dash.n_gated,
                "start": self._t_first,
                "latest": self._t_latest,
            }
        span = (doc["latest"] or 0) - (doc["start"] or 0)
        doc["rate_msg_s"] = round(doc["messages"] / span, 2) if span > 0 \
            else None
        bs = self._block_stats
        if bs is not None:
            doc["pipeline"] = {
                "preambles": bs.preambles, "crc_ok": bs.crc_ok,
                "corrected": bs.corrected, "crc_fail": bs.crc_fail,
                "emitted": bs.emitted, "overflow": bs.overflow,
                "ring_dropped": bs.ring_dropped,
            }
        return doc

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            with self._lock:
                self._n_bad += 1
            return
        self.update_report(rep)

    def update_report(self, rep, trusted: bool = False) -> None:
        """Feed an already-built AircraftReport (e.g. an mlat solution
        that never existed as a wire message). trusted=True bypasses the
        dashboard's AP-overlay icao gate (mlat solutions verified the
        address by multi-station correlation, not a lone syndrome)."""
        with self._lock:
            self._n_messages += 1
            self._df_counts[str(rep.df)] = \
                self._df_counts.get(str(rep.df), 0) + 1
            if rep.status in (STATUS_CORRECTED_1, STATUS_CORRECTED_2):
                self._n_corrected += 1
            if rep.lat is not None:
                self._n_positions += 1
            if rep.icao is not None and (
                    trusted or rep.df not in AP_ADDRESS_DFS
                    or rep.icao in self._seen_icaos
                    or rep.icao in self._dash.aircraft):
                # unique_aircraft counts VALIDATED addresses (same rule
                # as the dashboard's icao gate): an unvalidated
                # AP-overlay syndrome is a phantom ~every few seconds on
                # busy marginal traffic, and the ungated set both
                # inflated the stat and grew without bound
                if len(self._seen_icaos) > 1 << 17:
                    self._seen_icaos.clear()   # day-scale safety valve;
                    # the count restarts rather than growing forever
                self._seen_icaos.add(rep.icao)
            if self._t_first is None:
                self._t_first = rep.timestamp
            self._t_latest = rep.timestamp
            if rep.bearing_deg is not None and rep.range_nm is not None:
                self._azm.add(rep.bearing_deg, rep.range_nm,
                              rep.altitude_ft)
            now = rep.timestamp
            # one critical section for stats AND dashboard: a GET thread
            # must never observe counters that include a message whose
            # aircraft snapshot does not yet reflect it
            # dash mutation AND build_doc (which prunes, i.e. mutates)
            # stay under the lock: GET threads also call build_doc via
            # aircraft_doc, and unlocked concurrent iterate+delete over
            # dash.aircraft is a crash
            self._dash.update(rep, trusted=trusted)
            # re-serialize at most once per second of stream time (also
            # when stream time stepped BACKWARDS past the last snapshot
            # by more than that second: a wall-extrapolated quiet-gap
            # snapshot may sit ahead of a stream that lags wall clock —
            # e.g. during a long first compile — and must not suppress
            # refreshes once decode resumes. The 1 s hysteresis keeps
            # multichannel interleaving, whose timestamps regress by one
            # block step between channels, from re-serializing per
            # message); requests only ever read the cached bytes
            if self._last_snap is None or now - self._last_snap >= 1.0 \
                    or now < self._last_snap - 1.0:
                import time as _time
                self._snapshot = json.dumps(
                    build_doc(self._dash, now)).encode()
                self._last_snap = now
                self._last_snap_wall = _time.time()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
