"""Client for the inference service (octseg_torch.infer.serve, or octseg's).

The port of octseg/infer/client.py. Sends a DICOM pullback to a running
service and writes predict's files locally: per frame ``*_overlay.png`` and
``*_mask.png``, rendering each NDJSON mask block as it streams in, through
predict's ``render_mask_block`` (the overlay postprocess runs on ``device``,
default ``auto``: the GPU; ``cpu`` off the card), so the PNGs are
byte-identical to a local predict run over the same masks. ``format=quant``
fetches the per-frame quantification rows into ``quant.json`` and never
imports the engine or the models.

Config: configs/client.yaml.
Usage: python -m octseg_torch.infer.client server_url=http://host:7884 \\
    dcm_path=<abs .dcm> save_dir=<abs> [format=quant]
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request

import numpy as np

import octseg_torch
from octseg_torch.core.config import Config, entry_point

log = logging.getLogger(__name__)


def stream_pullback(server_url: str, dcm_path: str, fmt: str = 'masks',
                    timeout: float = 3600.0):
    """POST the DICOM at ``dcm_path`` and yield the parsed NDJSON records
    (``format=masks``) or the single quant payload (``format=quant``)."""
    with open(dcm_path, 'rb') as f:
        body = f.read()
    url = f'{server_url.rstrip("/")}/v1/pullback'
    if fmt != 'masks':
        url += f'?format={fmt}'
    req = urllib.request.Request(url, data=body, method='POST')
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if fmt == 'quant':
            yield json.loads(resp.read())
            return
        for line in resp:
            if line.strip():
                yield json.loads(line)


def save_block(frames: np.ndarray, block: dict, header: dict, classes, save_dir: str,
               base: str, width: int, device=None) -> None:
    """Render one streamed block through predict's render recipe."""
    from octseg_torch.infer.predict import render_mask_block
    from octseg_torch.infer.serve import decode_block

    masks = decode_block(block, block['count'], header['height'], header['width'])
    render_mask_block(frames, masks, block['start'], (header['height'], header['width']),
                      classes, save_dir, base, width, device=device)


def run(cfg: Config) -> int:
    """Drive one pullback through the service; returns the frames written."""
    fmt = cfg.get('format', 'masks')
    dcm_path = octseg_torch.project_path(cfg.dcm_path)
    save_dir = octseg_torch.project_path(cfg.save_dir)
    os.makedirs(save_dir, exist_ok=True)
    if fmt == 'quant':
        payload = next(stream_pullback(cfg.server_url, dcm_path, 'quant'))
        out = os.path.join(save_dir, 'quant.json')
        with open(out, 'w') as f:
            json.dump(payload, f, indent=1)
        log.info('Quantified %d frames -> %s', payload['frames'], out)
        return int(payload['frames'])

    # masks: render blocks as they stream; the frames are read again here for
    # the overlay (the service sends no pixels back). Imported here so that
    # quant mode stays off the engine's imports.
    from octseg_torch.infer.predict import load_pullback_frames

    device = octseg_torch.resolve_device(cfg.get('device', 'auto'))
    frames = load_pullback_frames(dcm_path)
    base = os.path.splitext(os.path.basename(dcm_path))[0]
    width = len(str(frames.shape[0]))
    header = None
    done = 0
    complete = False
    for rec in stream_pullback(cfg.server_url, dcm_path, 'masks'):
        if rec['type'] == 'header':
            header = rec
        elif rec['type'] == 'block':
            save_block(frames, rec, header, cfg.classes, save_dir, base, width, device)
            done += rec['count']
            log.info('rendered frames %d-%d / %d', rec['start'] + 1,
                     rec['start'] + rec['count'], header['frames'])
        elif rec['type'] == 'end':
            complete = True
            log.info('server wall: %.1f s', rec['seconds'])
    # a server that failed mid-pullback closes the stream: the missing end
    # record is the truncation signal, raised instead of exiting 0 with
    # partial PNGs
    if header is None or not complete or done != header['frames']:
        raise RuntimeError(
            f'stream truncated: rendered {done} of '
            f'{header["frames"] if header else "?"} frames (no end record)'
            if not complete else
            f'stream incomplete: rendered {done} of {header["frames"]} frames')
    return done


@entry_point('client')
def main(cfg: Config) -> None:
    run(cfg)


if __name__ == '__main__':
    main()
