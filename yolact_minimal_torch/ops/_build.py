"""Build and load the port's CUDA kernels (`csrc/*.cu`) and its one host
library (`csrc/nms.cc`).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface and loaded with `ctypes`; no PyTorch headers are involved,
so a build takes seconds. Libraries land in `build/torch_kernels/` at the
repository root, named by a hash of the source, the headers beside it
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt at its
next use and an unchanged one is reused.

Every kernel entry point returns the `cudaError_t` of its launch; `launch`
raises when it is not 0 (a refused launch never runs, and a later
synchronize would not report it).

The host library (greedy NMS for --traditional_nms) is compiled by `g++`
with the flags of `native/Makefile` into `build/torch_host/`, named by a
hash of its source and the flags; `native/` itself is never built.
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
HOST_BUILD_DIR = BUILD_DIR.parent / 'torch_host'
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17', '-Wall')

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


def cxx_path() -> str:
    path = shutil.which('g++')
    if path is None:
        raise RuntimeError('g++ not found: the host library csrc/nms.cc builds with g++')
    return path


def host_target(name: str) -> Path:
    """The library of `csrc/{name}.cc`, named by its source and CXX_FLAGS."""
    source = (CSRC / f'{name}.cc').read_bytes()
    digest = hashlib.sha256(source + b'\0' + ' '.join(CXX_FLAGS).encode()).hexdigest()[:16]
    return HOST_BUILD_DIR / f'lib{name}_{digest}.so'


def host_command(name: str, out: Path) -> list:
    return [cxx_path(), *CXX_FLAGS, '-o', str(out), str(CSRC / f'{name}.cc')]


def build_host(name: str) -> Path:
    """Compile `csrc/{name}.cc` with g++ unless its library is up to date.
    The library is written to a temporary file and moved into place, so
    processes that build it at once each see a whole file. Raises with g++'s
    log if the build fails."""
    target = host_target(name)
    if not target.exists():
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.run(host_command(name, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'g++ failed for csrc/{name}.cc:\n{proc.stdout}{proc.stderr}')
        os.replace(tmp, target)
    return target


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of `csrc/{name}.cc`, built at first use."""
    key = f'{name}.cc'
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build_host(name)))
    return _loaded[key]
