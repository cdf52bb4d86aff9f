"""The benchmark of the PyTorch and CUDA port (`yolact_minimal_torch`).

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on one card. Everything a cell needs is
found by name: its configuration under `configs/`, its traffic mix under
`traffic/`, its entry under `entries/`, and each per-layer metric's reader
under `metrics/`.
"""
