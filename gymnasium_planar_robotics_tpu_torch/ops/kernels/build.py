"""Build and load the port's CUDA kernels.

The sources in ``gymnasium_planar_robotics_tpu_torch/csrc`` (every ``*.cu``,
with the ``*.cuh`` headers they include) are compiled by ``nvcc`` at first
use into one shared library with a plain C interface, loaded with
``ctypes``: one ``nvcc -c`` per source, all started together, then one link.
The library lands in ``build/torch_kernels/`` at the root of the checkout
(``GPRT_TORCH_BUILD_DIR`` overrides it), named by a hash of every source and
header and the flags, so a changed file rebuilds and an unchanged tree loads
the cached library.  It is written under a temporary name and renamed, so a
half-written library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lib = None
#: seconds the last build took (0.0 when the cached library was loaded),
#: the seconds from its start to each source's end (``source_seconds``) and
#: the compiler's report (``-Xptxas -v``: registers, spills per kernel)
build_info: dict = {}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob('*.cu'))


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob('*.cuh'))


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
    for path in sources() + headers():
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp_dir) / f'{src.stem}.o'
            cmd = [nvcc, *NVCC_FLAGS, '-I', str(SRC_DIR), '-c', '-o', str(obj), str(src)]
            objs.append(obj)
            with open(Path(tmp_dir) / f'{src.stem}.log', 'w') as log_file:
                procs.append((src, cmd, subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT)))
        # seconds from the start to each source's end (they compile in parallel)
        seconds, pending = {}, list(procs)
        while pending:
            for item in [p for p in pending if p[2].poll() is not None]:
                seconds[item[0].name] = round(time.perf_counter() - t0, 1)
                pending.remove(item)
            time.sleep(0.05)
        logs, failed = [], []
        for src, cmd, proc in procs:
            logs.append(' '.join(cmd) + '\n' + (Path(tmp_dir) / f'{src.stem}.log').read_text())
            if proc.returncode != 0:
                failed.append(f'{cmd[-1]} ({proc.returncode})')
        tmp = Path(tmp_dir) / lib_path.name
        if not failed:
            cmd = [nvcc, '-shared', '-gencode', 'arch=compute_90a,code=sm_90a', '-o', str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f'link ({proc.returncode})')
        log = '\n'.join(logs)
        (out_dir / 'build.log').write_text(log)
        if failed:
            raise RuntimeError(f'nvcc failed: {failed}\n{log[-6000:]}')
        os.replace(tmp, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=str(lib_path), source_seconds=seconds)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i64, i32, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64
        for names in ('gprt_const_names', 'gprt_planning_const_names'):
            getattr(handle, names).restype = ctypes.c_char_p
            getattr(handle, names).argtypes = []
        handle.gprt_noise_probe.restype = i32
        handle.gprt_noise_probe.argtypes = [p, p, i64, i32, u64, p, p]
        # (in, noise, out, B, consts, num_cycles, jerk, box, seed, seed_dev, producer, stream)
        handle.gprt_pushing_cycles.restype = i32
        handle.gprt_pushing_cycles.argtypes = [p, p, p, i64, p, i32, i32, i32, u64, p, i32, p]
        # (st, act, noise, out, feat, B, consts, num_cycles, cand_k, jerk, box, seed, seed_dev, producer, stream)
        handle.gprt_pushing_autoreset.restype = i32
        handle.gprt_pushing_autoreset.argtypes = [p, p, p, p, p, i64, p, i32, i32, i32, i32, u64, p, i32, p]
        handle.gprt_pushing_rollout.restype = i32
        handle.gprt_pushing_rollout.argtypes = [p, p, p, p, p, i64, i32, p, i32, i32, i32, i32, u64, p, i32, p]
        # (in, noise, out, B, consts, table, n_cells, box, full, jerk, num_cycles, seed, seed_dev, producer,
        #  stream)
        handle.gprt_planning_cycles.restype = i32
        handle.gprt_planning_cycles.argtypes = [p, p, p, i64, p, p, i32, i32, i32, i32, i32, u64, p, i32, p]
        # (st, act, noise, out, B, consts, table, n_cells, box, full, jerk, num_cycles, cand_k, seed, seed_dev,
        #  producer, stream)
        handle.gprt_planning_autoreset.restype = i32
        handle.gprt_planning_autoreset.argtypes = [p, p, p, p, i64, p, p, i32, i32, i32, i32, i32, i32, u64, p, i32,
                                                   p]
        # (st, actions, noise, st_out, step_out, B, K, consts, table, n_cells, box, full, jerk, num_cycles,
        #  cand_k, seed, seed_dev, producer, stream)
        handle.gprt_planning_rollout.restype = i32
        handle.gprt_planning_rollout.argtypes = [p, p, p, p, p, i64, i32, p, p, i32, i32, i32, i32, i32, i32, u64, p,
                                                 i32, p]
        # (st, act, noise, out, B, consts, multi_consts, table, n_cells, m, lanes, slots, box, full, jerk,
        #  num_cycles, cand_k, seed, seed_dev, stream); multi_consts in device memory
        handle.gprt_planning_multi_autoreset.restype = i32
        handle.gprt_planning_multi_autoreset.argtypes = [p, p, p, p, i64, p, p, p, i32, i32, i32, i32, i32, i32, i32,
                                                         i32, i32, u64, p, p]
        # (x, out, n, k, transc, stream); chains per thread of each probe
        handle.gprt_peak.restype = i32
        handle.gprt_peak.argtypes = [p, p, i64, i32, i32, p]
        handle.gprt_peak_chains.restype = i32
        handle.gprt_peak_chains.argtypes = [i32]
        handle.gprt_split_layout.restype = ctypes.c_char_p
        handle.gprt_split_layout.argtypes = []
        handle.gprt_multi_const_names.restype = ctypes.c_char_p
        handle.gprt_multi_const_names.argtypes = []
        # field names of gprt::Consts and gprt::PlanningConsts, in order; (name, length rule) of kernel H's
        # constants vector
        handle.const_names = tuple(handle.gprt_const_names().decode().rstrip(',').split(','))
        handle.planning_const_names = tuple(handle.gprt_planning_const_names().decode().rstrip(',').split(','))
        handle.multi_const_fields = tuple(tuple(f.split(':')) for f in
                                          handle.gprt_multi_const_names().decode().rstrip(',').split(','))
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {err}')
