"""Inference service: a lean HTTP API over the ensemble engine.

The port of octseg/infer/serve.py, with the same routes, codes, wire format
and metric names, so octseg's client and dashboards read it unchanged:

    POST /v1/pullback            body = DICOM pullback bytes (native or JPEG)
         ?format=masks (default) -> NDJSON stream (HTTP/1.0, delimited by
                                    the connection's close): a header line,
                                    one line per engine block with the
                                    bitpacked ensemble masks (base64 of
                                    np.packbits, see ``decode_block``), then
                                    an end line. Blocks stream as the engine
                                    yields them (``iter_pullback``).
         ?format=quant           -> one JSON document of per-frame
                                    quantification rows (area, thickness,
                                    instance tracking by slice continuity),
                                    ``analyze/analysis.quantify_frame``.
    GET  /healthz                -> JSON {status, platform, devices, models,
                                    classes, output_size}.
    GET  /metrics                -> Prometheus text (octseg_* series).

One pullback runs on the device at a time (a device lock); a bounded
admission semaphore of ``1 + max_queued`` lets a few more wait, and beyond
it the service answers 503 with Retry-After. Errors before the 200 is on
the wire answer 500; after it the stream closes without its end record,
which the client reads as truncation; a client that drops counts as 499.
A request refused before its upload is read (400, 404, 503) has the upload
read and dropped first, so that a client that sends all of it before
reading gets the answer and not a reset connection (octseg's server closes
with the upload unread, and a large upload then meets a broken pipe
instead of its 503).

Differences from the JAX package: ``device`` (default ``auto``: the GPU)
comes from the config, as in predict; the engine runs under ``fp32_exact``
(engine.py), whose TF32 switches are process-wide, so it is entered inside
the device lock; ``int8: true`` raises NotImplementedError before any model
loads; AOT exports are not consulted (ROADMAP.md, "Opt-in, last").

Config: configs/serve.yaml.
Usage: python -m octseg_torch.infer.serve models_dir=<abs> [port=7884] [key=value ...]
"""

from __future__ import annotations

import base64
import json
import logging
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

import octseg_torch
from octseg_torch.analyze.analysis import quantify_frame
from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.registry import CLASS_IDS
from octseg_torch.infer.engine import MODELS_META, InferenceEngine, fp32_exact
from octseg_torch.infer.predict import check_ported, load_pullback_frames

log = logging.getLogger(__name__)

MAX_BODY_BYTES = 8 << 30  # refuse uploads beyond 8 GiB (the largest study is about 1.5 GB)


def encode_block(block_masks: np.ndarray) -> Dict[str, Any]:
    """(k, H, W, 4) {0,1} float32 masks -> JSON-able dict with base64 of
    np.packbits over the raveled uint8 bits."""
    bits = np.packbits(block_masks.astype(np.uint8).ravel())
    return {'data': base64.b64encode(bits.tobytes()).decode('ascii')}


def decode_block(line: Dict[str, Any], count: int, out_h: int, out_w: int,
                 n_classes: int = 4) -> np.ndarray:
    """The client's inverse of :func:`encode_block`."""
    raw = np.frombuffer(base64.b64decode(line['data']), np.uint8)
    total = count * out_h * out_w * n_classes
    return (np.unpackbits(raw, count=total)
            .reshape(count, out_h, out_w, n_classes).astype(np.float32))


class Metrics:
    """Thread-safe counters exposed in Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[tuple, int] = {}
        self.frames_total = 0
        self.request_seconds_sum = 0.0
        self.busy = 0
        self.admitted = 0
        self.rejected_total = 0

    def count(self, endpoint: str, status: int) -> None:
        with self._lock:
            key = (endpoint, status)
            self.requests[key] = self.requests.get(key, 0) + 1

    def render(self) -> str:
        with self._lock:
            lines = [
                '# TYPE octseg_requests_total counter',
                *(f'octseg_requests_total{{endpoint="{e}",status="{s}"}} {v}'
                  for (e, s), v in sorted(self.requests.items())),
                '# TYPE octseg_frames_total counter',
                f'octseg_frames_total {self.frames_total}',
                '# TYPE octseg_request_seconds_sum counter',
                f'octseg_request_seconds_sum {self.request_seconds_sum:.3f}',
                '# TYPE octseg_busy gauge',
                f'octseg_busy {self.busy}',
                '# TYPE octseg_queued gauge',  # admitted but not yet on the device
                f'octseg_queued {max(0, self.admitted - self.busy)}',
                '# TYPE octseg_rejected_total counter',
                f'octseg_rejected_total {self.rejected_total}',
            ]
        return '\n'.join(lines) + '\n'


class ServeState:
    """Engine and admission control shared across handler threads."""

    def __init__(self, cfg: Config):
        check_ported(cfg)
        self.cfg = cfg
        self.classes = list(cfg.get('classes', list(CLASS_IDS)))
        self.output_size = [int(v) for v in cfg.get('output_size', [1000, 1000])]
        self.engine = InferenceEngine(
            models_dir=octseg_torch.project_path(cfg.models_dir), classes=self.classes,
            block_size=int(cfg.get('block_size', 128)),
            output_resize=str(cfg.get('output_resize', 'prob_bilinear')),
            device=cfg.get('device', 'auto'), bf16=bool(cfg.get('bf16', False)))
        self.metrics = Metrics()
        # one pullback on the device at a time (the three models' activations
        # need the card's memory), a small bounded queue, then 503
        self._device_lock = threading.Lock()
        self._admission = threading.BoundedSemaphore(1 + int(cfg.get('max_queued', 1)))
        self.spool_dir = cfg.get('spool_dir') or tempfile.mkdtemp(prefix='octseg-serve-')

    def admit(self) -> bool:
        ok = self._admission.acquire(blocking=False)
        with self.metrics._lock:
            if ok:
                self.metrics.admitted += 1
            else:
                self.metrics.rejected_total += 1
        return ok

    def release(self) -> None:
        with self.metrics._lock:
            self.metrics.admitted -= 1
        self._admission.release()

    def device(self):
        return self._device_lock

    def health(self) -> Dict[str, Any]:
        cuda = self.engine.device.type == 'cuda'
        return {
            'status': 'ok',
            'platform': 'gpu' if cuda else 'cpu',
            'devices': torch.cuda.device_count() if cuda else 1,
            'models': sorted({m['model_dir'] for c, m in MODELS_META.items()
                              if c in self.classes}),
            'classes': self.classes,
            'output_size': self.output_size,
        }


def quantify_blocks(blocks: Iterable[Tuple[int, np.ndarray]], n_frames: int,
                    classes: Sequence[str], output_size: Sequence[int],
                    native: bool = True) -> Dict[str, Any]:
    """The quant payload of a pullback's mask blocks ``(start, (k, H, W, 4)
    {0,1} masks)`` at ``output_size``: per class the frames whose channel
    holds both values, their instance ids by slice continuity and
    ``quantify_frame``'s numbers (``native=False``: the Python tracer).
    A block's channels are reduced on a thread pool, since the C++ tracer
    runs outside the interpreter lock; the Python tracer holds it, and
    threads would only contend for it, so it runs on one."""
    # the masks are quantified at output_size, so the px -> unit ratio comes
    # from that resolution
    ratio = max(1, int(output_size[0] * 150 // 1000))
    objects: Dict[str, Dict[str, list]] = {
        c: {'slice': [], 'object_id': [], 'area': [], 'thickness_mean': [],
            'thickness_min': []} for c in classes}
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1) if native else 1) as pool:
        for start, block_masks in blocks:
            blk = block_masks.astype(np.uint8)
            # the analyzer's rule: a frame counts only when the channel holds
            # both values (an all-set mask is skipped too)
            jobs = [(start + j, class_name, channel)
                    for j in range(blk.shape[0]) for class_name in classes
                    for channel in (blk[j, :, :, CLASS_IDS[class_name] - 1] * 255,)
                    if channel.any() and not channel.all()]
            rows = pool.map(lambda job: quantify_frame(job[2], ratio, native=native), jobs)
            for (idx, class_name, _channel), q in zip(jobs, rows):
                obj = objects[class_name]
                if not obj['object_id']:
                    obj['object_id'].append(0)
                elif idx == obj['slice'][-1] + 1:
                    obj['object_id'].append(obj['object_id'][-1])
                else:
                    obj['object_id'].append(obj['object_id'][-1] + 1)
                obj['slice'].append(idx)
                obj['area'].append(q['area'])
                obj['thickness_mean'].append(q['thickness_mean'])
                obj['thickness_min'].append(q['thickness_min'])
    return {'frames': int(n_frames), 'ratio': ratio, 'output_size': list(output_size),
            'objects': objects}


def quantify_pullback(state: ServeState, frames: np.ndarray) -> Dict[str, Any]:
    """Run the ensemble over ``frames`` and reduce each frame to
    quantification rows (the analyzer's math without a work dir or image
    payloads)."""
    return quantify_blocks(state.engine.iter_pullback(frames, state.output_size),
                           frames.shape[0], state.classes, state.output_size)


def make_handler(state: ServeState):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: responses are delimited by the connection's close, which
        # lets the masks endpoint stream NDJSON lines without chunked framing
        protocol_version = 'HTTP/1.0'

        def log_message(self, fmt, *args):
            log.info('%s - %s', self.address_string(), fmt % args)

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None) -> None:
            self._send(code, json.dumps(obj).encode(), 'application/json', headers)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == '/healthz':
                self._send_json(200, state.health())
                state.metrics.count('healthz', 200)
            elif path == '/metrics':
                self._send(200, state.metrics.render().encode(), 'text/plain; version=0.0.4')
            else:
                self._send_json(404, {'error': f'no route {path}'})
                state.metrics.count('other', 404)

        def _discard_body(self) -> None:
            """Read and drop the request body before a refusal: a socket
            closed with unread data resets the connection, and a client that
            sends its whole upload before reading (urllib does) then sees a
            broken pipe instead of the answer. Bodies above MAX_BODY_BYTES
            stay unread."""
            remaining = int(self.headers.get('Content-Length') or 0)
            if remaining > MAX_BODY_BYTES:
                return
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 20))
                if not chunk:
                    return
                remaining -= len(chunk)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != '/v1/pullback':
                self._discard_body()
                self._send_json(404, {'error': f'no route {parsed.path}'})
                state.metrics.count('other', 404)
                return
            fmt = parse_qs(parsed.query).get('format', ['masks'])[0]
            if fmt not in ('masks', 'quant'):
                self._discard_body()
                self._send_json(400, {'error': f'unknown format {fmt!r}'})
                state.metrics.count('pullback', 400)
                return
            length = int(self.headers.get('Content-Length') or 0)
            if length <= 0:
                self._send_json(411, {'error': 'Content-Length required'})
                state.metrics.count('pullback', 411)
                return
            if length > MAX_BODY_BYTES:
                self._send_json(413, {'error': f'body exceeds {MAX_BODY_BYTES}'})
                state.metrics.count('pullback', 413)
                return
            if not state.admit():
                self._discard_body()
                self._send_json(503, {'error': 'busy'}, headers={'Retry-After': '10'})
                state.metrics.count('pullback', 503)
                return
            t0 = time.time()
            self._streaming_started = False
            try:
                self._handle_pullback(length, fmt)
            except BrokenPipeError:
                log.warning('client dropped mid-stream')
                state.metrics.count('pullback', 499)  # client closed
            except Exception as e:  # a 500, never the server's end
                log.exception('pullback request failed')
                if not self._streaming_started:
                    try:
                        self._send_json(500, {'error': str(e)})
                    except OSError:
                        pass
                # else the 200 and NDJSON headers are on the wire: a second
                # status line would corrupt the stream, so close it; the
                # client detects the missing end record
                state.metrics.count('pullback', 500)
            finally:
                state.release()
                with state.metrics._lock:
                    state.metrics.request_seconds_sum += time.time() - t0

        def _handle_pullback(self, length: int, fmt: str) -> None:
            # spool the upload: the DICOM parser reads a path, and a file
            # keeps the request body out of resident memory
            fd, spool = tempfile.mkstemp(dir=state.spool_dir, suffix='.dcm')
            try:
                with os.fdopen(fd, 'wb') as f:
                    remaining = length
                    while remaining:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            raise IOError('truncated request body')
                        f.write(chunk)
                        remaining -= len(chunk)
                frames = load_pullback_frames(spool)
            finally:
                try:
                    os.unlink(spool)
                except OSError:
                    pass

            with state.device(), fp32_exact():
                with state.metrics._lock:
                    state.metrics.busy = 1
                try:
                    if fmt == 'quant':
                        self._send_json(200, quantify_pullback(state, frames))
                    else:
                        self._stream_masks(frames)
                finally:
                    with state.metrics._lock:
                        state.metrics.busy = 0
                        state.metrics.frames_total += int(frames.shape[0])
            state.metrics.count('pullback', 200)

        def _stream_masks(self, frames: np.ndarray) -> None:
            out_h, out_w = state.output_size
            self.send_response(200)
            self.send_header('Content-Type', 'application/x-ndjson')
            self.end_headers()
            self._streaming_started = True

            def line(obj: Dict[str, Any]) -> None:
                self.wfile.write(json.dumps(obj).encode() + b'\n')
                self.wfile.flush()

            line({'type': 'header', 'frames': int(frames.shape[0]),
                  'height': out_h, 'width': out_w,
                  'classes': state.classes, 'encoding': 'packbits',
                  'channel_order': list(CLASS_IDS)})
            t0 = time.time()
            for start, block_masks in state.engine.iter_pullback(frames, state.output_size):
                rec = {'type': 'block', 'start': int(start), 'count': int(block_masks.shape[0])}
                rec.update(encode_block(block_masks))
                line(rec)
            line({'type': 'end', 'frames': int(frames.shape[0]),
                  'seconds': round(time.time() - t0, 3)})

    return Handler


def serve(cfg: Config, block: bool = True) -> ThreadingHTTPServer:
    """Start the service on ``cfg.host``:``cfg.port`` (port 0: any free
    one); with ``block=False`` on a daemon thread, returning the server
    (its ``octseg_state`` is the ServeState; ``shutdown()`` stops it)."""
    state = ServeState(cfg)
    httpd = ThreadingHTTPServer((cfg.get('host', '0.0.0.0'), int(cfg.get('port', 7884))),
                                make_handler(state))
    httpd.octseg_state = state
    log.info('octseg_torch serving on %s:%d (models=%s classes=%s device=%s)',
             *httpd.server_address, state.engine.models_dir, state.classes,
             state.engine.device)
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@entry_point('serve')
def main(cfg: Config) -> None:
    serve(cfg, block=True)


if __name__ == '__main__':
    main()
