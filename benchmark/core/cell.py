"""A cell's files, found by name.

`BENCHMARK.json` at the root names the cell (configuration + traffic) and
its metrics. The configuration is the file its `configs` entry names; the traffic mix
is `traffic/<traffic>.json`, which names the entry (`entries/<entry>.py`);
the cell's comparison limits are `workloads/<cell>.json`; each per-layer
metric is read by `metrics/<metric>.py`.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                      # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file of the benchmark, by path (names may hold dots)."""
    name = 'benchmark_' + path.stem.replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int
    overrides: Dict[str, int] = field(default_factory=dict)

    @property
    def entry(self) -> ModuleType:
        return load_module(HERE / 'entries' / f'{self.traffic["entry"]}.py')

    def size(self, key: str) -> int:
        """A traffic size (batch, img_size, ...), as a test may shrink it."""
        return self.overrides.get(key, self.traffic.get(key, self.config.get(key)))


def _for_cell(metrics: List[dict], name: str, reported: set) -> List[dict]:
    out = []
    for m in metrics:
        if 'workloads' in m:
            if name in m['workloads']:
                out.append(m)
        elif m.get('moves') is None or m['moves'] in reported:
            out.append(m)
    return out


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / 'BENCHMARK.json')
    work = next((w for w in bench['workloads'] if w['name'] == name), None)
    if work is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                       f'{[w["name"] for w in bench["workloads"]]}')
    conf = next(c for c in bench['configs'] if c['name'] == work['config'])
    e2e = _for_cell(bench['end_to_end'], name, set())
    reported = {m['name'] for m in e2e}
    return Cell(name=name, config=load_json(ROOT / conf['file']),
                traffic=load_json(HERE / 'traffic' / f'{work["traffic"]}.json'),
                limits=load_json(HERE / 'workloads' / f'{name}.json'),
                end_to_end=e2e, per_layer=_for_cell(bench['per_layer'], name, reported),
                chips=work['chips'])


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / 'metrics' / f'{name}.py')
