""""KCC OCT analysis" web app: a standard-library HTTP server and an HTML/JS
front end (the port of octseg/analyze/app.py).

DICOM upload (inference on the card) or demo mode -> object presence map,
per-frame viewer with slider, class checkboxes and opacity, area trace
plot, per-instance area boxplots, metadata JSON. The routes are octseg's,
with the three analytics plots as SVG documents (``/object_map.svg``,
``/trace_area.svg``, ``/plot_area.svg``; octseg serves matplotlib PNGs):
``/`` the page, ``/contours.json`` the viewer's polygons
(``frame_contours``), ``/base_frame.png`` a frame, ``/frame.png`` the
server-rendered composite (``get_img_show``), ``/metadata.json`` the
analysis without its masks, and ``POST /analyze?mode=demo|inference`` (the
DICOM as the body) which answers ``{n_frames, classes, sid}``, 400 for an
upload that is not a DICOM with pixel data (octseg answers 500), 500 when
the analysis fails. Each
analysis gets its own session id and work dir; the oldest sessions beyond
``max_sessions`` are dropped, with the work dirs this app created under
``temp_dir``. Analyses run one at a time (one device); GETs never wait on
them.

Config: configs/app.yaml (``device`` may be added: the GPU unless 'cpu').
Usage: python -m octseg_torch.analyze.app [key=value ...]
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import uuid
from glob import glob
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from octseg_torch.analyze import figures
from octseg_torch.analyze.analysis import frame_contours, get_analysis
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.data import dicom

log = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>KCC OCT analysis</title>
<style>
 body{font-family:sans-serif;margin:20px;background:#fafafa}
 .row{margin:12px 0} img{max-width:100%;border:1px solid #ddd;background:#fff}
 button{padding:8px 16px} label{margin-right:12px}
 #controls{display:none}
 #viewer{position:relative;display:inline-block}
 #overlay{position:absolute;left:0;top:0;pointer-events:none}
 #overlay polygon{pointer-events:auto;stroke-width:1.5}
 #tooltip{position:fixed;display:none;background:rgba(20,20,20,.85);color:#fff;
   padding:6px 10px;border-radius:4px;font-size:13px;pointer-events:none;z-index:10}
</style></head>
<body>
<h2>KCC OCT analysis</h2>
<div class="row">
  <input type="file" id="dicom" accept="*">
  <button onclick="analyze('inference')">Analyze DICOM</button>
  <button onclick="analyze('demo')">Run demo</button>
  <span id="status"></span>
</div>
<div id="controls">
  <div class="row"><img id="object_map"></div>
  <div class="row">
    <label>Frame: <input type="range" id="frame" min="0" max="0" value="0"
      oninput="updateFrame()"> <span id="frameno">0</span></label>
    <label>Opacity %: <input type="range" id="opacity" min="0" max="100" value="30"
      oninput="applyOpacity()"></label>
    <span id="classes"></span>
  </div>
  <div class="row"><div id="viewer">
    <img id="frameimg" onload="sizeOverlay()">
    <svg id="overlay"></svg>
  </div></div>
  <div id="tooltip"></div>
  <div class="row"><img id="trace_area"></div>
  <div class="row"><img id="plot_area"></div>
  <div class="row"><details><summary>Metadata</summary><pre id="meta"></pre></details></div>
</div>
<script>
let CLASSES = [], SID = '', CONTOURS = null;
function qsClasses(){
  return CLASSES.filter(c=>document.getElementById('cls_'+c).checked).join(',');
}
async function analyze(mode){
  document.getElementById('status').textContent = 'Processing...';
  let opts = {method:'POST'};
  if(mode==='inference'){
    const f = document.getElementById('dicom').files[0];
    if(!f){alert('Choose a DICOM file first');return;}
    opts.body = await f.arrayBuffer();
  }
  const r = await fetch('/analyze?mode='+mode, opts);
  if(!r.ok){document.getElementById('status').textContent='Error: '+await r.text();return;}
  const info = await r.json();
  CLASSES = info.classes; SID = info.sid;
  const cl = document.getElementById('classes');
  cl.innerHTML = CLASSES.map(c=>
    `<label><input type="checkbox" id="cls_${c}" checked onchange="updateAll()">${c}</label>`
  ).join('');
  document.getElementById('frame').max = info.n_frames-1;
  document.getElementById('controls').style.display='block';
  document.getElementById('status').textContent = info.n_frames+' frames';
  document.getElementById('object_map').src = '/object_map.svg?sid='+SID+'&t='+Date.now();
  const meta = await (await fetch('/metadata.json?sid='+SID)).json();
  document.getElementById('meta').textContent = JSON.stringify(meta, null, 1).slice(0, 20000);
  updateAll();
}
function updateAll(){
  const c = qsClasses();
  document.getElementById('trace_area').src = '/trace_area.svg?sid='+SID+'&classes='+c+'&t='+Date.now();
  document.getElementById('plot_area').src = '/plot_area.svg?sid='+SID+'&classes='+c+'&t='+Date.now();
  updateFrame();
}
let FRAME_SEQ = 0;
async function updateFrame(){
  const n = document.getElementById('frame').value;
  const seq = ++FRAME_SEQ;  // rapid slider moves: only the latest wins
  document.getElementById('frameno').textContent = n;
  document.getElementById('frameimg').src = '/base_frame.png?sid='+SID+'&num='+n;
  const c = await (await fetch('/contours.json?sid='+SID+'&num='+n)).json();
  if(seq !== FRAME_SEQ) return;  // a newer request superseded this one
  CONTOURS = c;
  renderOverlay();
}
function renderOverlay(){
  const svg = document.getElementById('overlay');
  if(!CONTOURS){svg.innerHTML='';return;}
  const on = new Set(qsClasses().split(','));
  svg.setAttribute('viewBox', '0 0 '+CONTOURS.width+' '+CONTOURS.height);
  svg.setAttribute('preserveAspectRatio', 'none');
  let parts = [];
  for(const o of CONTOURS.objects){
    if(!on.has(o.class)) continue;
    const rgb = 'rgb('+o.color.join(',')+')';
    const tip = `${o.class} — area: ${o.area}, thickness mean: ${o.thickness_mean}, min: ${o.thickness_min}`;
    for(const poly of o.polygons){
      const pts = poly.map(p=>p[0]+','+p[1]).join(' ');
      parts.push(`<polygon points="${pts}" fill="${rgb}" stroke="${rgb}" data-tip="${tip}"></polygon>`);
    }
  }
  svg.innerHTML = parts.join('');
  applyOpacity();
  sizeOverlay();
  for(const p of svg.querySelectorAll('polygon')){
    p.addEventListener('mousemove', e=>{
      const t = document.getElementById('tooltip');
      t.style.display='block';
      t.style.left=(e.clientX+14)+'px'; t.style.top=(e.clientY+14)+'px';
      t.textContent = p.dataset.tip;
    });
    p.addEventListener('mouseleave', ()=>{
      document.getElementById('tooltip').style.display='none';
    });
  }
}
function applyOpacity(){
  const o = document.getElementById('opacity').value/100;
  for(const p of document.querySelectorAll('#overlay polygon'))
    p.setAttribute('fill-opacity', o);
}
function sizeOverlay(){
  const img = document.getElementById('frameimg');
  const svg = document.getElementById('overlay');
  svg.style.width = img.clientWidth+'px';
  svg.style.height = img.clientHeight+'px';
}
window.addEventListener('resize', sizeOverlay);
</script>
</body></html>
"""


class AppState:
    """Per-session analyses: each POST /analyze gets a session id; viewers
    address their session explicitly, or the latest one."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.sessions: Dict[str, Dict] = {}
        self.latest: Optional[str] = None
        self.lock = threading.Lock()  # guards the sessions dict only
        self.analysis_lock = threading.Lock()  # serializes analyses (one device)
        self.max_sessions = int(cfg.get('max_sessions', 8))

    def put(self, data: Dict) -> str:
        sid = uuid.uuid4().hex[:12]
        evicted = []
        with self.lock:
            self.sessions[sid] = data
            self.latest = sid
            while len(self.sessions) > self.max_sessions:
                oldest = next(iter(self.sessions))
                if oldest == sid:
                    break
                evicted.append(self.sessions.pop(oldest))
        for old in evicted:  # outside the lock: disk cleanup can be slow
            self._cleanup(old)
        return sid

    def _cleanup(self, data: Dict) -> None:
        """Delete an evicted session's work dir, but only a dir this app
        created under temp_dir (demo sessions point at the shared demo
        data, which must survive)."""
        work_dir = data.get('work_dir')
        temp_root = os.path.abspath(self.cfg.get('temp_dir', 'data/app/temp'))
        if not work_dir:
            return
        wd = os.path.abspath(work_dir)
        if wd.startswith(temp_root + os.sep) and os.path.isdir(wd):
            shutil.rmtree(wd, ignore_errors=True)

    def get(self, sid: Optional[str]) -> Optional[Dict]:
        with self.lock:
            return self.sessions.get(sid or self.latest or '')


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str = 'text/html', code: int = 200):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.debug(fmt, *args)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == '/':
                return self._send(_PAGE.encode())
            data = state.get(q.get('sid'))
            if data is None:
                return self._send(b'Run analysis first', 'text/plain', 400)
            classes = [c for c in q.get('classes', '').split(',') if c] or list(CLASS_IDS)
            if url.path == '/object_map.svg':
                return self._send(figures.get_object_map(data), 'image/svg+xml')
            if url.path == '/trace_area.svg':
                return self._send(figures.get_trace_area(classes, data), 'image/svg+xml')
            if url.path == '/plot_area.svg':
                return self._send(figures.get_plot_area(classes, data), 'image/svg+xml')
            if url.path == '/contours.json':
                payload = frame_contours(data, int(q.get('num', 0)))
                return self._send(json.dumps(payload).encode(), 'application/json')
            if url.path == '/base_frame.png':
                # eviction race: put() may remove this session's work dir
                # while we hold the session dict: answer 410
                img_dir = os.path.join(data['work_dir'], 'img')
                if not os.path.isdir(img_dir):
                    return self._send(b'session evicted', 'text/plain', 410)
                imgs = sorted(glob(os.path.join(img_dir, '*.png')))
                num = int(q.get('num', 0))
                if not imgs or num < 0 or num >= len(imgs):
                    return self._send(b'no such frame', 'text/plain', 404)
                try:
                    with open(imgs[num], 'rb') as f:
                        return self._send(f.read(), 'image/png')
                except OSError:
                    return self._send(b'session evicted', 'text/plain', 410)
            if url.path == '/frame.png':  # server-rendered fallback viewer
                img_dir = os.path.join(data['work_dir'], 'img')
                num = int(q.get('num', 0))
                n_frames = len(glob(os.path.join(img_dir, '*.png')))
                if not os.path.isdir(img_dir):
                    return self._send(b'session evicted', 'text/plain', 410)
                if num < 0 or num >= n_frames:
                    return self._send(b'no such frame', 'text/plain', 404)
                try:
                    png = figures.get_img_show(data, img_dir=img_dir, img_num=num,
                                               classes_vis=classes,
                                               opacity=float(q.get('opacity', 20)))
                except OSError:
                    return self._send(b'session evicted', 'text/plain', 410)
                return self._send(png, 'image/png')
            if url.path == '/metadata.json':
                slim = {k: v for k, v in data.items() if k != 'objects'}
                slim['objects'] = {
                    c: {k: v for k, v in obj.items() if k != 'masks'}
                    for c, obj in data['objects'].items()
                }
                return self._send(json.dumps(slim).encode(), 'application/json')
            return self._send(b'not found', 'text/plain', 404)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != '/analyze':
                return self._send(b'not found', 'text/plain', 404)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            mode = q.get('mode', 'demo')
            tmp = None
            try:
                # read the upload outside any lock (a slow client must not
                # stall other sessions), then serialize only the analysis
                if mode != 'demo':
                    length = int(self.headers.get('Content-Length', 0))
                    blob = self.rfile.read(length)
                    with tempfile.NamedTemporaryFile(delete=False) as f:
                        f.write(blob)
                        tmp = f.name
                    # an upload that is not a DICOM with pixel data is the
                    # client's fault: 400 (octseg answers every failure 500)
                    try:
                        readable = 'PixelData' in dicom.dcmread(tmp)
                    except Exception as e:  # noqa: BLE001 - any parse failure
                        readable, why = False, str(e)
                    else:
                        why = 'no PixelData'
                    if not readable:
                        return self._send(f'not a readable DICOM: {why}'.encode(),
                                          'text/plain', 400)
                with state.analysis_lock:
                    if mode == 'demo':
                        data = get_analysis(None, 'demo',
                                            demo_dir=state.cfg.get('demo_dir', 'data/app/demo'))
                    else:
                        data = get_analysis(tmp, 'inference',
                                            models_dir=state.cfg.get('models_dir', 'models'),
                                            temp_root=state.cfg.get('temp_dir', 'data/app/temp'),
                                            device=state.cfg.get('device'))
                sid = state.put(data)
                info = {'n_frames': len(data['images']), 'classes': list(CLASS_IDS),
                        'sid': sid}
                return self._send(json.dumps(info).encode(), 'application/json')
            except Exception as e:  # surface errors to the UI
                log.exception('analysis failed')
                return self._send(str(e).encode(), 'text/plain', 500)
            finally:
                if tmp is not None:  # the upload's copy
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass

    return Handler


def serve(cfg: Config, block: bool = True) -> ThreadingHTTPServer:
    """Start the app on cfg.host:cfg.port (port 0: a free port); ``block``
    serves in this thread, else in a daemon thread (``server.shutdown()``
    stops it)."""
    state = AppState(cfg)
    server = ThreadingHTTPServer((cfg.get('host', '0.0.0.0'), int(cfg.get('port', 7883))),
                                 make_handler(state))
    server.app_state = state
    log.info('KCC OCT analysis app on http://%s:%d', *server.server_address)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@entry_point('app')
def main(cfg: Config) -> None:
    serve(cfg, block=True)


if __name__ == '__main__':
    main()
