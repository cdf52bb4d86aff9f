"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface and loaded with `ctypes`; no PyTorch headers are involved,
so a build takes seconds. Libraries land in `build/torch_kernels/` at the
repository root, named by a hash of the source, the headers beside it
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt at its
next use and an unchanged one is reused.

Every kernel entry point returns the `cudaError_t` of its launch; `launch`
raises when it is not 0 (a refused launch never runs, and a later
synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                           'machine with the CUDA toolkit')
    return path


def _target(name: str) -> Path:
    # the headers too: a source that includes an edited header is rebuilt
    parts = [(CSRC / f'{name}.cu').read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob('*.cuh'))]
    digest = hashlib.sha256(b'\0'.join(parts) + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}_{digest}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together. Raises if any fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f'.{os.getpid()}.tmp')
            cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{n}.cu')]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, t)
        errors = []
        for n, (proc, tmp, t) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f'nvcc failed for csrc/{n}.cu:\n{log}')
            else:
                os.replace(tmp, t)
        if errors:
            raise RuntimeError('\n'.join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/{name}.cu`, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def launch(fn, *args) -> None:
    """Call a kernel entry point and raise on a nonzero cudaError_t."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f'CUDA launch of {fn.__name__} failed: '
                           f'cudaError_t {err}')
