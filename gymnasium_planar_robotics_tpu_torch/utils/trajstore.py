"""Trajectory store: a background-threaded native writer and a random-access
reader.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/trajstore.py``, with
the same on-disk format: shards ``shard_NNNNNN.bin`` of frames, each a
12-byte header (the magic ``0x54524A31``, the length) and the frame's
bytes, and an append-only index ``index.bin`` of ``{u32 shard, u64 offset,
u64 length}`` records, little-endian.  A store written here reads with the
JAX package's reader and the other way round.

The native runtime is the repository's ``native/trajstore/trajstore.cpp``
(ctypes, no pybind11), compiled at first use with ``g++`` and the flags of
its Makefile into ``build/trajstore/`` at the root of the checkout (named by
a hash of the source and the command), under a file lock, so processes that
reach the first build together build it once.  A failed build raises,
naming the command; nothing falls back.  The pure-Python writer and reader
(same format) run only when asked for (``native=False``).

``pack_pytree`` flattens tensors, arrays, dicts (keys sorted, as JAX
flattens them), lists, tuples and dataclasses (fields in order) without JAX,
so ``unpack_arrays`` of a frame written here yields the leaves JAX would
for the same tree.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import io
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / 'native' / 'trajstore' / 'trajstore.cpp'
CXXFLAGS = ('-O3', '-std=c++17', '-fPIC', '-Wall', '-pthread')  # native/trajstore/Makefile
_MAGIC = 0x54524A31

_lib = None
#: the last build's command, seconds (0.0 for a cached library) and path
build_info: dict = {}


def build_dir() -> Path:
    return _ROOT / 'build' / 'trajstore'


def _compiler() -> str:
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('g++ not found (set CXX): the trajectory store is built from native/trajstore at first use')
    return cxx


def build() -> Path:
    """Compile ``native/trajstore/trajstore.cpp`` unless a library for this
    source and command exists; returns the library's path."""
    cxx = _compiler()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join((cxx, *CXXFLAGS)).encode()).hexdigest()[:16]
    lib_path = out_dir / f'libtrajstore_{digest}.so'
    with open(out_dir / '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time; the others wait, then load it
        if lib_path.exists():
            build_info.update(seconds=0.0, path=str(lib_path))
            return lib_path
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = Path(tmp) / lib_path.name
            cmd = [cxx, *CXXFLAGS, '-shared', '-o', str(tmp_lib), str(SOURCE)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'the trajectory store did not build: {" ".join(cmd)} exited {proc.returncode}\n'
                                   f'{proc.stdout}{proc.stderr}')
            os.replace(tmp_lib, lib_path)
        build_info.update(command=' '.join(cmd), seconds=time.perf_counter() - t0, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, u64 = ctypes.c_void_p, ctypes.c_uint64
        for name, res, args in (
            ('ts_writer_open', p, [ctypes.c_char_p, u64, u64]),
            ('ts_writer_append', ctypes.c_int, [p, ctypes.c_char_p, u64]),
            ('ts_writer_frames_written', u64, [p]),
            ('ts_writer_queue_bytes', u64, [p]),
            ('ts_writer_close', ctypes.c_int, [p]),
            ('ts_reader_open', p, [ctypes.c_char_p]),
            ('ts_reader_count', u64, [p]),
            ('ts_reader_length', u64, [p, u64]),
            ('ts_reader_get', ctypes.c_int64, [p, u64, ctypes.c_char_p, u64]),
            ('ts_reader_close', None, [p]),
        ):
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = res, args
        _lib = handle
    return _lib


def native_available() -> bool:
    """True when the native library is loaded, or builds and loads now
    (``lib()``); False, without raising, where no compiler is found or the
    build or the load fails.  It selects nothing: the writer and the reader
    stay native unless ``native=False`` is asked for."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in JAX's order; its structure."""
    if tree is None:
        return 'None'
    if isinstance(tree, dict):
        return '{' + ', '.join(f'{k!r}: {_flatten(tree[k], leaves)}' for k in sorted(tree)) + '}'
    if isinstance(tree, list):
        return '[' + ', '.join(_flatten(v, leaves) for v in tree) + ']'
    if isinstance(tree, tuple):
        inner = ', '.join(_flatten(v, leaves) for v in tree)
        return f'({inner},)' if len(tree) == 1 else f'({inner})'
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ', '.join(_flatten(getattr(tree, f.name), leaves) for f in dataclasses.fields(tree))
        return f'CustomNode({type(tree).__name__}[()], [{inner}])'
    leaves.append(tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree))
    return '*'


def pack_pytree(tree) -> bytes:
    """Serialise a tree of tensors or arrays to bytes (an npz container: the
    leaves as ``leaf_i`` and the structure as ``treedef``)."""
    leaves: list = []
    structure = f'PyTreeDef({_flatten(tree, leaves)})'
    buf = io.BytesIO()
    np.savez(buf, treedef=np.frombuffer(structure.encode(), dtype=np.uint8),
             **{f'leaf_{i}': leaf for i, leaf in enumerate(leaves)})
    return buf.getvalue()


def unpack_arrays(data: bytes) -> list[np.ndarray]:
    """The leaf arrays of a frame, in order (the structure is the caller's)."""
    with np.load(io.BytesIO(data)) as z:
        n = sum(1 for k in z.files if k.startswith('leaf_'))
        return [z[f'leaf_{i}'] for i in range(n)]


class TrajWriter:
    """Append-only frame sink: the native background writer, or with
    ``native=False`` the synchronous pure-Python one (same format)."""

    def __init__(self, directory: str | Path, shard_bytes: int = 64 << 20, max_queue_bytes: int = 256 << 20,
                 native: bool = True):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._native = None
        self._final_count = 0
        if native:
            self._lib = lib()
            self._native = self._lib.ts_writer_open(str(self._dir).encode(), shard_bytes, max_queue_bytes)
            if not self._native:
                raise IOError(f'the native writer could not open {self._dir}')
            return
        self._shard_bytes = shard_bytes
        # resume from an existing index: shards open in append mode, so the
        # offsets continue from the last indexed frame
        self._shard_id = self._shard_used = self._count = 0
        idx = self._dir / 'index.bin'
        if idx.exists():
            raw = idx.read_bytes()
            for i in range(0, len(raw), 20):
                shard, off, length = struct.unpack_from('<IQQ', raw, i)
                self._shard_id, self._shard_used = shard, off + 12 + length
                self._count += 1
        self._shard = open(self._dir / f'shard_{self._shard_id:06d}.bin', 'ab')
        self._index = open(idx, 'ab')

    def append(self, frame: bytes) -> None:
        """Append one opaque frame: queued to the native writer's thread, or
        written and flushed at once by the Python one."""
        if self._native is not None:
            rc = self._lib.ts_writer_append(self._native, frame, len(frame))
            if rc != 0:
                raise IOError(f'trajstore writer error {rc}')
            return
        if self._shard_used > 0 and self._shard_used + len(frame) > self._shard_bytes:
            self._shard.close()
            self._shard_id += 1
            self._shard = open(self._dir / f'shard_{self._shard_id:06d}.bin', 'ab')
            self._shard_used = 0
        off = self._shard_used
        self._shard.write(struct.pack('<IQ', _MAGIC, len(frame)))
        self._shard.write(frame)
        self._shard.flush()
        self._index.write(struct.pack('<IQQ', self._shard_id, off, len(frame)))
        self._index.flush()
        self._shard_used += 12 + len(frame)
        self._count += 1

    def append_pytree(self, tree) -> None:
        """Serialise a tree of tensors or arrays (``pack_pytree``) and append it."""
        self.append(pack_pytree(tree))

    @property
    def frames_written(self) -> int:
        if self._native is not None:
            return int(self._lib.ts_writer_frames_written(self._native))
        return getattr(self, '_count', self._final_count)

    def close(self) -> None:
        """Drain the native writer's queue and close every file."""
        if self._native is not None:
            # wait for the queue to drain, then for the count to settle (the
            # thread pops a frame before it writes it)
            while int(self._lib.ts_writer_queue_bytes(self._native)) > 0:
                time.sleep(0.001)
            prev, cur = -1, int(self._lib.ts_writer_frames_written(self._native))
            while cur != prev:
                time.sleep(0.002)
                prev, cur = cur, int(self._lib.ts_writer_frames_written(self._native))
            self._final_count = cur
            rc = self._lib.ts_writer_close(self._native)
            self._native = None
            if rc != 0:
                raise IOError(f'trajstore writer close error {rc}')
        elif getattr(self, '_shard', None):
            self._shard.close()
            self._index.close()
            self._shard = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajReader:
    """Random access by frame id over a written directory: native, or with
    ``native=False`` pure Python."""

    def __init__(self, directory: str | Path, native: bool = True):
        self._dir = Path(directory)
        self._native = None
        if native:
            self._lib = lib()
            self._native = self._lib.ts_reader_open(str(self._dir).encode())
            if not self._native:
                raise IOError(f'the native reader could not open {self._dir}')
        else:
            raw = (self._dir / 'index.bin').read_bytes()
            self._index = [struct.unpack_from('<IQQ', raw, i) for i in range(0, len(raw), 20)]

    def __len__(self) -> int:
        if self._native is not None:
            return int(self._lib.ts_reader_count(self._native))
        return len(self._index)

    def get(self, i: int) -> bytes:
        """Frame ``i`` verbatim (IndexError if unreadable)."""
        if self._native is not None:
            n = int(self._lib.ts_reader_length(self._native, i))
            buf = ctypes.create_string_buffer(n)
            got = self._lib.ts_reader_get(self._native, i, buf, n)
            if got < 0:
                raise IndexError(f'frame {i} unreadable')
            return buf.raw[:got]
        if not 0 <= i < len(self._index):
            raise IndexError(f'frame {i} unreadable')
        shard, off, length = self._index[i]
        with open(self._dir / f'shard_{shard:06d}.bin', 'rb') as f:
            f.seek(off)
            magic, ln = struct.unpack('<IQ', f.read(12))
            if magic != _MAGIC or ln != length:
                raise IOError(f'frame {i}: corrupt header')
            return f.read(ln)

    def get_arrays(self, i: int) -> list[np.ndarray]:
        """Frame ``i`` decoded as its list of arrays."""
        return unpack_arrays(self.get(i))

    def close(self) -> None:
        """Release the native reader (nothing to do for the Python one)."""
        if self._native is not None:
            self._lib.ts_reader_close(self._native)
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
