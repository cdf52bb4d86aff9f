"""One run of one cell of BENCHMARK.json on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start) makes the cell's weights and inputs from
the seed and warms up its shapes; the window then runs the cell's entry in
a closed loop for --seconds; with --trace 1 a bounded slice of calls after
it is profiled and the per-layer metrics are read from its events. The
program's state is freed, the reference judges what the timed calls
produced, and the last line of standard output is one JSON object:
correct, attempted, failed, metrics, device[, breakdown], checks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc, 10 ms ticks)."""
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    return uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK')


_STARTED = (time.perf_counter(), _process_age())
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _fail(msg: str, code: int) -> None:
    print(msg, file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from benchmark.core import cell as cells
    from benchmark.core.run import run_cell

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        _fail('no CUDA device: the benchmark runs on the card only', 3)
    if torch.cuda.device_count() < cell.chips:
        _fail(f'{args.workload} needs {cell.chips} cards, found {torch.cuda.device_count()}', 3)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device('cuda', 0), started=_STARTED)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
