"""Build and load the port's CUDA kernels.

The sources in ``gymnasium_planar_robotics_tpu_torch/csrc`` are compiled by
``nvcc`` at first use into one shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in ``build/torch_kernels/`` at the
root of the checkout (``GPRT_TORCH_BUILD_DIR`` overrides it), named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads the cached file.  It is written under a temporary name and renamed, so
a half-written library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / 'csrc'
SOURCES = ('noise_probe.cu', 'pushing_cycles.cu', 'pushing_autoreset.cu', 'pushing_rollout.cu')
HEADERS = ('pushing.cuh',)
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_lib = None
#: seconds the last build took (0.0 when the cached library was loaded) and
#: the compiler's report (``-Xptxas -v``: registers, spills per kernel)
build_info: dict = {}


def build_dir() -> Path:
    return Path(os.environ.get('GPRT_TORCH_BUILD_DIR', _PKG.parent / 'build' / 'torch_kernels'))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc'),
        shutil.which('nvcc'),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels are built from source at first use')


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library for the current sources exists."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f'libgprt_kernels_{_digest()}.so'
    if lib_path.exists():
        build_info.update(seconds=0.0, log='(cached)', path=str(lib_path))
        return lib_path
    tmp = out_dir / f'.{lib_path.name}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(SRC_DIR), '-o', str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out_dir / 'build.log').write_text(' '.join(cmd) + '\n' + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log[-4000:]}')
    os.replace(tmp, lib_path)
    build_info.update(seconds=seconds, log=log, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i64, i32, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64
        handle.gprt_const_names.restype = ctypes.c_char_p
        handle.gprt_const_names.argtypes = []
        handle.gprt_noise_probe.restype = i32
        handle.gprt_noise_probe.argtypes = [p, p, i64, i32, u64, p]
        handle.gprt_pushing_cycles.restype = i32
        handle.gprt_pushing_cycles.argtypes = [p, p, p, i64, p, i32, i32, u64, p]
        handle.gprt_pushing_autoreset.restype = i32
        handle.gprt_pushing_autoreset.argtypes = [p, p, p, p, i64, p, i32, i32, i32, u64, p]
        handle.gprt_pushing_rollout.restype = i32
        handle.gprt_pushing_rollout.argtypes = [p, p, p, p, p, i64, i32, p, i32, i32, i32, u64, p]
        # field names of gprt::Consts, in order
        handle.const_names = tuple(handle.gprt_const_names().decode().rstrip(',').split(','))
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {err}')
