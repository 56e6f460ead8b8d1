"""STL mesh support: parsing, sizing, predefined mover meshes.

The port's own copy of the JAX package's ``utils/meshes.py`` (numpy only),
so that the port imports nothing of the JAX package.  A mover's size is the
AABB half-extents of its STL mesh, parsed directly (binary or ASCII): the
quantity the reference environment measures with its ``_find_mesh_dimensions``
(``basic_envs.py:1341-1394``).

The predefined commercial mover and bumper meshes are not shipped: this
module knows their shape parameters (outer dimensions, corner radius, inner
opening, from the public datasheets) and generates faithful STLs on first
use into the port's ``assets/`` directory (git-ignored): movers are
rounded-corner slabs, bumpers rounded-corner frames that wrap the mover.
Nothing is downloaded.
"""

from __future__ import annotations

import os
import re
import struct
import tempfile
from pathlib import Path

import numpy as np

ASSET_DIR = Path(__file__).parent.parent / 'assets'

# outer (x, y, z) dimensions [m] of the predefined movers/bumpers — the only
# property the reference's pipeline extracts from the mesh (AABB sizing)
PREDEFINED_MESH_DIMS: dict[str, tuple[float, float, float]] = {
    'beckhoff_apm4220_mover': (0.098, 0.098, 0.0121),
    'beckhoff_apm4220_bumper': (0.113, 0.113, 0.012),
    'beckhoff_apm4330_mover': (0.140, 0.140, 0.0121),
    'beckhoff_apm4330_bumper': (0.155, 0.155, 0.012),
    'beckhoff_apm4550_mover': (0.220, 0.220, 0.0121),
    'beckhoff_apm4550_bumper': (0.235, 0.235, 0.012),
    'planar_motor_M3-06': (0.1179, 0.1179, 0.0098),
    'planar_motor_M3-15': (0.328, 0.208, 0.0118),
    'planar_motor_M3-25': (0.448, 0.448, 0.0158),
    'planar_motor_M4-11': (0.236, 0.156, 0.0124),
    'planar_motor_M4-18': (0.316, 0.316, 0.0124),
}

# silhouette parameters: corner radius [m] and, for bumpers, the inner
# opening half-extent [m] (bumpers are frames that wrap the mover).
# Measured from the real parts' geometry (corner max(|x|+|y|) deficit and
# mid-band min radial distance): Beckhoff movers r=6 mm; Beckhoff bumpers
# r=23.2 mm with openings 42.5/63.9/103.5 mm; Planar Motor movers r=23.5 mm
PREDEFINED_MESH_STYLE: dict[str, dict] = {
    'beckhoff_apm4220_mover': dict(corner_r=0.0060),
    'beckhoff_apm4220_bumper': dict(corner_r=0.0232, inner_half=0.0425),
    'beckhoff_apm4330_mover': dict(corner_r=0.0060),
    'beckhoff_apm4330_bumper': dict(corner_r=0.0232, inner_half=0.0639),
    'beckhoff_apm4550_mover': dict(corner_r=0.0060),
    'beckhoff_apm4550_bumper': dict(corner_r=0.0232, inner_half=0.1035),
    'planar_motor_M3-06': dict(corner_r=0.0235),
    'planar_motor_M3-15': dict(corner_r=0.0235),
    'planar_motor_M3-25': dict(corner_r=0.0235),
    'planar_motor_M4-11': dict(corner_r=0.0235),
    'planar_motor_M4-18': dict(corner_r=0.0235),
}

#: bumped when the generator's geometry changes so stale cached assets
#: regenerate (embedded in the STL's 80-byte header)
_GEN_TAG = b'gprt-stl-v2'


def read_stl_vertices(path: str | Path) -> np.ndarray:
    """All triangle vertices of an STL file as an [N, 3] float array."""
    data = Path(path).read_bytes()
    if data[:5] == b'solid' and b'facet' in data[:500]:
        matches = re.findall(rb'vertex\s+([-\d.eE+]+)\s+([-\d.eE+]+)\s+([-\d.eE+]+)', data)
        return np.array(matches, dtype=np.float64)
    (n,) = struct.unpack('<I', data[80:84])
    tris = np.frombuffer(data[84 : 84 + n * 50], dtype=np.uint8).reshape(n, 50)
    return tris[:, 12:48].copy().view('<f4').astype(np.float64).reshape(-1, 3)


def mesh_half_extents(path: str | Path, scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """AABB half-extents of a (scaled) mesh — the quantity the reference's
    ``_find_mesh_dimensions`` computes (basic_envs.py:1341-1394, halved at
    :1435)."""
    v = read_stl_vertices(path) * np.asarray(scale, dtype=np.float64)
    return (v.max(axis=0) - v.min(axis=0)) / 2.0


def write_box_stl(path: str | Path, dims, chamfer_frac: float = 0.08) -> None:
    """Write a chamfered-box binary STL with outer dimensions ``dims``.

    Used to generate stand-in assets for the predefined mover names: an
    octagonal prism (chamfered corners, like the real movers' rounded
    bumpers) whose AABB matches the commercial part's footprint.
    """
    dx, dy, dz = (float(d) / 2.0 for d in dims)
    c = chamfer_frac * min(dx, dy) * 2.0
    # octagon vertices (counter-clockwise, top view)
    ring = np.array(
        [
            (-dx + c, -dy), (dx - c, -dy), (dx, -dy + c), (dx, dy - c),
            (dx - c, dy), (-dx + c, dy), (-dx, dy - c), (-dx, -dy + c),
        ]
    )
    top = np.hstack([ring, np.full((8, 1), dz)])
    bot = np.hstack([ring, np.full((8, 1), -dz)])

    tris = []
    for k in range(1, 7):  # top + bottom fans
        tris.append((top[0], top[k], top[k + 1]))
        tris.append((bot[0], bot[k + 1], bot[k]))
    for k in range(8):  # side quads
        a, b = k, (k + 1) % 8
        tris.append((bot[a], bot[b], top[b]))
        tris.append((bot[a], top[b], top[a]))

    with open(path, 'wb') as f:
        f.write(b'\0' * 80)
        f.write(struct.pack('<I', len(tris)))
        for t in tris:
            t = np.asarray(t, dtype=np.float32)
            n = np.cross(t[1] - t[0], t[2] - t[0])
            nn = np.linalg.norm(n)
            n = n / nn if nn > 0 else n
            f.write(n.astype('<f4').tobytes())
            f.write(t.astype('<f4').tobytes())
            f.write(b'\0\0')


def _rounded_rect_ring(hx: float, hy: float, r: float, segs: int = 6) -> np.ndarray:
    """Counter-clockwise [N, 2] outline of a rounded-corner rectangle with
    half-extents (hx, hy) and corner radius r (``segs`` arc segments per
    corner)."""
    r = min(r, hx, hy)
    cx = np.array([hx - r, -(hx - r), -(hx - r), hx - r])
    cy = np.array([hy - r, hy - r, -(hy - r), -(hy - r)])
    start = np.array([0.0, 0.5, 1.0, 1.5]) * np.pi
    pts = []
    for k in range(4):
        ang = start[k] + np.linspace(0.0, np.pi / 2, segs + 1)
        pts.append(np.stack([cx[k] + r * np.cos(ang), cy[k] + r * np.sin(ang)], axis=-1))
    return np.concatenate(pts, axis=0)


def _write_stl(path: str | Path, tris: list) -> None:
    """Binary STL with the generator tag in the header (regeneration key)."""
    with open(path, 'wb') as f:
        f.write(_GEN_TAG.ljust(80, b'\0'))
        f.write(struct.pack('<I', len(tris)))
        for t in tris:
            t = np.asarray(t, dtype=np.float32)
            n = np.cross(t[1] - t[0], t[2] - t[0])
            nn = np.linalg.norm(n)
            n = n / nn if nn > 0 else n
            f.write(n.astype('<f4').tobytes())
            f.write(t.astype('<f4').tobytes())
            f.write(b'\0\0')


def write_rounded_slab_stl(path: str | Path, dims, corner_r: float, segs: int = 6) -> None:
    """Rounded-corner slab (the real movers' silhouette): a convex prism
    whose top/bottom faces fan from the centroid."""
    hx, hy, hz = (float(d) / 2.0 for d in dims)
    ring = _rounded_rect_ring(hx, hy, corner_r, segs)
    n = len(ring)
    top = np.hstack([ring, np.full((n, 1), hz)])
    bot = np.hstack([ring, np.full((n, 1), -hz)])
    ct, cb = np.array([0.0, 0.0, hz]), np.array([0.0, 0.0, -hz])
    tris = []
    for k in range(n):
        a, b = k, (k + 1) % n
        tris.append((ct, top[a], top[b]))
        tris.append((cb, bot[b], bot[a]))
        tris.append((bot[a], bot[b], top[b]))
        tris.append((bot[a], top[b], top[a]))
    _write_stl(path, tris)


def write_rounded_frame_stl(path: str | Path, dims, corner_r: float, inner_half: float, segs: int = 6) -> None:
    """Rounded-corner FRAME (the real bumpers): a ring whose outer outline is
    a rounded rectangle and whose inner opening is the square the mover sits
    in.  The annulus is triangulated by clamping each outer vertex onto the
    inner square (quad strip per edge), giving watertight top/bottom/walls."""
    hx, hy, hz = (float(d) / 2.0 for d in dims)
    outer = _rounded_rect_ring(hx, hy, corner_r, segs)
    inner = np.clip(outer, -inner_half, inner_half)
    n = len(outer)
    to, bo = (np.hstack([outer, np.full((n, 1), z)]) for z in (hz, -hz))
    ti, bi = (np.hstack([inner, np.full((n, 1), z)]) for z in (hz, -hz))
    tris = []
    for k in range(n):
        a, b = k, (k + 1) % n
        # top + bottom annulus
        tris.append((ti[a], to[a], to[b]))
        tris.append((ti[a], to[b], ti[b]))
        tris.append((bi[a], bo[b], bo[a]))
        tris.append((bi[a], bi[b], bo[b]))
        # outer + inner walls
        tris.append((bo[a], bo[b], to[b]))
        tris.append((bo[a], to[b], to[a]))
        tris.append((bi[a], ti[b], bi[b]))
        tris.append((bi[a], ti[a], ti[b]))
    _write_stl(path, tris)


def write_predefined_stl(path: str | Path, name: str) -> None:
    """Generate the faithful stand-in for a predefined mesh name."""
    dims = PREDEFINED_MESH_DIMS[name]
    style = PREDEFINED_MESH_STYLE[name]
    if 'inner_half' in style:
        write_rounded_frame_stl(path, dims, style['corner_r'], style['inner_half'])
    else:
        write_rounded_slab_stl(path, dims, style['corner_r'])


def resolve_mesh_path(name_or_path: str | None, asset_dir: str | Path | None = None) -> Path | None:
    """Resolve a predefined mesh name or a user path to an STL file.

    Mirrors the reference's ``_resolve_mesh_path`` (basic_envs.py:1439-1463)
    but generates the predefined asset on first use instead of shipping
    copyrighted geometry.
    """
    if name_or_path is None:
        return None
    if name_or_path in PREDEFINED_MESH_DIMS:
        directory = Path(asset_dir) if asset_dir is not None else ASSET_DIR
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / f'{name_or_path}.stl'
        stale = True
        if path.exists():
            with open(path, 'rb') as f:
                stale = not f.read(80).startswith(_GEN_TAG)
        if stale:
            # atomic write: concurrent processes (parallel tests) must never
            # read a half-written STL
            fd, tmp = tempfile.mkstemp(dir=directory, suffix='.stl.tmp')
            os.close(fd)
            try:
                write_predefined_stl(tmp, name_or_path)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return path
    return Path(name_or_path)


def resolve_mover_size(
    mover_shape: str, mover_size, mesh_name_or_path=None, mesh_scale=(1.0, 1.0, 1.0), asset_dir=None
) -> np.ndarray:
    """Half-extent triple for a mover: direct for box/cylinder, measured from
    the mesh AABB for 'mesh' (reference ``_resolve_mover_size``,
    basic_envs.py:1396-1437)."""
    if mover_shape in ('box', 'cylinder'):
        return np.asarray(mover_size, dtype=np.float64).reshape(3)
    if mover_shape == 'mesh':
        path = resolve_mesh_path(mesh_name_or_path, asset_dir)
        assert path is not None, "mesh shape requires a mesh name or path"
        return mesh_half_extents(path, mesh_scale)
    raise ValueError(f'unknown mover shape: {mover_shape!r}')
