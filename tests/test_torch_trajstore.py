"""Port parity: ``utils/trajstore.py``, the trajectory store.

The native library builds from ``native/trajstore/trajstore.cpp`` into
``build/trajstore/`` (a broken source raises, naming the command); frames
round-trip, shards rotate, a reopened store appends; a store written by the
port reads with the JAX package's reader with equal leaves and the other way
round; the pure-Python writer and reader (``native=False``) share the
native format.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.utils import trajstore as jts
from gymnasium_planar_robotics_tpu_torch.utils import trajstore as ts


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {'obs': {'observation': rng.normal(size=(4, 2)).astype(np.float32),
                    'achieved_goal': rng.normal(size=(4, 2)).astype(np.float32)},
            'action': rng.uniform(-1, 1, (4, 2)).astype(np.float32), 'done': rng.random(4) > 0.5,
            'steps': np.arange(4, dtype=np.int32), 'seq': [np.ones(3), (np.zeros(2, np.int64), np.float64(2.5))]}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.as_tensor(tree)


def test_native_library_builds():
    path = ts.build()
    assert path.exists() and path.parent == ts.build_dir() and path.name.startswith('libtrajstore_')
    assert ts.lib() is ts.lib()


def test_failed_build_raises_naming_the_command(tmp_path, monkeypatch):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(ts, 'SOURCE', bad)
    monkeypatch.setattr(ts, 'build_dir', lambda: tmp_path / 'out')
    with pytest.raises(RuntimeError, match='g\\+\\+.*broken.cpp'):
        ts.build()


@pytest.mark.parametrize('native', [True, False])
def test_roundtrip_and_shard_rotation(tmp_path, native):
    frames = [bytes([i]) * (1000 * (i + 1)) for i in range(20)]
    with ts.TrajWriter(tmp_path, shard_bytes=8000, native=native) as w:
        for f in frames:
            w.append(f)
    assert w.frames_written == 20
    for reader_native in (True, False):
        with ts.TrajReader(tmp_path, native=reader_native) as r:
            assert len(r) == 20 and [r.get(i) for i in range(20)] == frames
            with pytest.raises(IndexError):
                r.get(20)
    assert len(list(tmp_path.glob('shard_*.bin'))) > 1


@pytest.mark.parametrize('native', [True, False])
def test_reopen_appends(tmp_path, native):
    with ts.TrajWriter(tmp_path, native=native) as w:
        w.append(b'first-run-frame')
    with ts.TrajWriter(tmp_path, native=native) as w:
        w.append(b'second-run-frame')
    assert w.frames_written == 2
    with ts.TrajReader(tmp_path) as r:
        assert len(r) == 2 and r.get(0) == b'first-run-frame' and r.get(1) == b'second-run-frame'


def test_port_store_reads_with_the_jax_reader(tmp_path):
    trees = [_tree(i) for i in range(3)]
    with ts.TrajWriter(tmp_path) as w:
        for t in trees:
            w.append_pytree(_torch_tree(t))
    with jts.TrajReader(tmp_path) as r:
        assert len(r) == 3
        for i, t in enumerate(trees):
            got = r.get_arrays(i)
            want = jts.unpack_arrays(jts.pack_pytree(t))  # the JAX package's leaves of the same tree
            assert len(got) == len(want) == 8
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_jax_store_reads_with_the_port_reader(tmp_path):
    trees = [_tree(10 + i) for i in range(3)]
    with jts.TrajWriter(tmp_path, shard_bytes=3000) as w:
        for t in trees:
            w.append_pytree({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in t.items()})
    for native in (True, False):
        with ts.TrajReader(tmp_path, native=native) as r:
            assert len(r) == 3
            for i, t in enumerate(trees):
                for a, b in zip(r.get_arrays(i), ts.unpack_arrays(ts.pack_pytree(t))):
                    np.testing.assert_array_equal(a, b)


def test_pack_flattens_like_jax():
    import dataclasses

    @dataclasses.dataclass
    class State:
        pos: torch.Tensor
        steps: torch.Tensor

    tree = {'z': torch.ones(2), 'a': State(pos=torch.zeros(3), steps=torch.arange(2)), 'none': None}
    leaves = ts.unpack_arrays(ts.pack_pytree(tree))
    assert [tuple(x.shape) for x in leaves] == [(3,), (2,), (2,)]  # a.pos, a.steps, z: keys sorted, fields in order
    np.testing.assert_array_equal(leaves[2], np.ones(2, np.float32))


def test_writer_keeps_up_with_a_fast_producer(tmp_path):
    payload = np.zeros(65536, dtype=np.uint8).tobytes()
    with ts.TrajWriter(tmp_path, shard_bytes=1 << 20) as w:
        for _ in range(200):
            w.append(payload)
    with ts.TrajReader(tmp_path) as r:
        assert len(r) == 200 and r.get(199) == payload
