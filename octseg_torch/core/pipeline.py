"""Pipeline runner: a hash-gated stage DAG (the port of
octseg/core/pipeline.py, the framework's ``dvc repro``).

Stages in a stage file declare cmd, deps and outs; content hashes are kept
in a lock file; ``repro`` orders the stages topologically by their dep/out
edges and runs a stage only when its cmd, a dep or an out changed (or an
out is missing); ``seconds`` keeps each run stage's wall time. A file's
hash is its MD5; a directory's is the MD5 of its files' relative paths,
sizes and whole-second mtimes. The stage file is read by
``core/config.load_yaml`` (no PyYAML).

The port's stage file is ``octseg_torch/pipeline.yaml`` (the repository
pipeline.yaml's DAG over the port's entry points). Stage commands run in
the working directory with this package importable and this interpreter's
directory first on PATH; the lock file is ``pipeline.lock`` there.

Usage: python -m octseg_torch.core.pipeline [stage ...] [-f] [--file FILE]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import octseg_torch
from octseg_torch.core.config import load_yaml

log = logging.getLogger(__name__)

STAGE_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          'pipeline.yaml')


def _hash_path(path: str) -> Optional[str]:
    """Content hash of a file, or a stable aggregate hash of a directory."""
    if os.path.isfile(path):
        h = hashlib.md5()
        with open(path, 'rb') as f:
            for chunk in iter(lambda: f.read(1 << 20), b''):
                h.update(chunk)
        return h.hexdigest()
    if os.path.isdir(path):
        h = hashlib.md5()
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                p = os.path.join(root, name)
                rel = os.path.relpath(p, path)
                st = os.stat(p)
                h.update(f'{rel}:{st.st_size}:{int(st.st_mtime)}'.encode())
        return h.hexdigest()
    return None


class Pipeline:
    def __init__(self, pipeline_file: str = STAGE_FILE, lock_file: Optional[str] = None):
        with open(pipeline_file) as f:
            spec = load_yaml(f.read())
        self.stages: Dict[str, dict] = spec['stages']
        self.lock_file = lock_file or os.path.join(os.getcwd(), 'pipeline.lock')
        self.lock: Dict[str, dict] = {}
        self.seconds: Dict[str, float] = {}   # wall seconds of each stage run
        if os.path.exists(self.lock_file):
            with open(self.lock_file) as f:
                self.lock = json.load(f)

    def _topo_order(self, targets: Optional[List[str]] = None) -> List[str]:
        producers = {}
        for name, stage in self.stages.items():
            for out in stage.get('outs') or []:
                producers[out] = name
        order: List[str] = []
        visiting: set = set()

        def visit(name: str):
            if name in order:
                return
            if name in visiting:
                raise ValueError(f'Pipeline cycle at stage {name!r}')
            visiting.add(name)
            for dep in self.stages[name].get('deps') or []:
                for out, producer in producers.items():
                    if dep == out or dep.startswith(out.rstrip('/') + '/'):
                        visit(producer)
            visiting.discard(name)
            order.append(name)

        for name in targets or list(self.stages):
            visit(name)
        return order

    def _stage_state(self, name: str) -> dict:
        stage = self.stages[name]
        return {
            'cmd': stage['cmd'],
            'deps': {d: _hash_path(d) for d in stage.get('deps') or []},
            'outs': {o: _hash_path(o) for o in stage.get('outs') or []},
        }

    def _is_stale(self, name: str) -> bool:
        if name not in self.lock:
            return True
        state = self._stage_state(name)
        locked = self.lock[name]
        if state['cmd'] != locked.get('cmd') or state['deps'] != locked.get('deps'):
            return True
        if any(h is None for h in state['outs'].values()):
            return True
        return state['outs'] != locked.get('outs')

    def repro(self, targets: Optional[List[str]] = None, force: bool = False) -> List[str]:
        """Run the stale stages in dependency order; returns the stages run."""
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            p for p in (octseg_torch.PROJECT_DIR, env.get('PYTHONPATH')) if p)
        env['PATH'] = os.pathsep.join(p for p in (os.path.dirname(sys.executable),
                                                  env.get('PATH')) if p)
        ran = []
        for name in self._topo_order(targets):
            if not force and not self._is_stale(name):
                log.info("Stage '%s' didn't change, skipping", name)
                continue
            cmd = self.stages[name]['cmd']
            log.info("Running stage '%s': %s", name, cmd)
            t = time.perf_counter()
            subprocess.run(cmd, shell=True, check=True, env=env)
            self.seconds[name] = time.perf_counter() - t
            log.info("Stage '%s' took %.1f s", name, self.seconds[name])
            self.lock[name] = self._stage_state(name)
            with open(self.lock_file, 'w') as f:
                json.dump(self.lock, f, indent=2)
            ran.append(name)
        return ran


def main() -> None:
    logging.basicConfig(level=logging.INFO, format='[%(levelname)s] %(message)s')
    parser = argparse.ArgumentParser(description='Reproduce pipeline stages')
    parser.add_argument('targets', nargs='*', help='stages to reproduce (default all)')
    parser.add_argument('-f', '--force', action='store_true')
    parser.add_argument('--file', default=STAGE_FILE)
    args = parser.parse_args()
    ran = Pipeline(args.file).repro(args.targets or None, force=args.force)
    log.info('Done; %d stage(s) ran', len(ran))


if __name__ == '__main__':
    main()
