"""Batched camera geometry as pure JAX functions.

Batched equivalent of the reference camera layer
(reference include/image/camera.hpp, source/image/camera.cpp): instead of a
CCamera object per image, all N cameras live in one struct-of-arrays
`CameraSet` pytree, and every operation is batched/jittable. Level-l
projection matrices are derived on the fly (rows 0-1 divided by 2^l,
reference camera.cpp:56-68) rather than stored.

Conventions: 3D points are homogeneous float arrays [..., 4] with w=1;
normals have w=0. Projections return [..., 3] = (x, y, 1) at the given
pyramid level, or PROJ_SENTINEL when behind the camera
(reference camera.hpp:89-108).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# Every f32 contraction of the engine asks for full f32 accuracy: by
# default a GPU may run an f32 dot in TF32 (~10 mantissa bits, about
# 0.5 px at 640 px), which moves projections and NCC scores.
HIGHEST = jax.lax.Precision.HIGHEST

PROJ_SENTINEL = -65535.0  # reference camera.hpp:95-99 (-0xffff)
_CLIP = 1.0e9


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CameraSet:
    """All cameras of a reconstruction problem, struct-of-arrays.

    Derived quantities follow CCamera::updateCamera
    (reference camera.cpp:109-136) and COptim::setAxesScales
    (reference source/pmvs/optim.cpp:43-64).
    """

    P: jax.Array          # [N, 3, 4] level-0 projections
    center: jax.Array     # [N, 4] optical centers (w = 1)
    oaxis: jax.Array      # [N, 4] unit optical axis, [3] = scaled offset
    xaxis: jax.Array      # [N, 3] image-plane x in world (unit)
    yaxis: jax.Array      # [N, 3]
    zaxis: jax.Array      # [N, 3] = oaxis[:3]
    ipscale: jax.Array    # [N] (|P0[:3]| + |P1[:3]|)/2   (camera.cpp:128-135)
    ipscale_optim: jax.Array  # [N] xaxis.P0[:3] + yaxis.P1[:3] (optim.cpp:55-63)

    @property
    def num(self) -> int:
        return self.P.shape[0]


def build_camera_set(P: np.ndarray, dtype=jnp.float32) -> CameraSet:
    """Derive all per-camera quantities from [N, 3, 4] projection matrices.

    Computed in float64 numpy for accuracy (the 3x3 inversion for optical
    centers is ill-conditioned in f32), then cast.
    """
    P = np.asarray(P, dtype=np.float64).reshape(-1, 3, 4)
    n = P.shape[0]

    # Optical axis (camera.cpp:112-118)
    oaxis = P[:, 2, :].copy()
    norms = np.linalg.norm(oaxis[:, :3], axis=1, keepdims=True)
    oaxis = oaxis / norms

    # Optical center: solve P[:, :3] c = -P[:, 3] (camera.cpp:155-173).
    center = np.ones((n, 4))
    ortho_mask = np.all(P[:, 2, :3] == 0.0, axis=1)
    for i in range(n):
        if ortho_mask[i]:
            v = np.cross(P[i, 0, :3], P[i, 1, :3])
            center[i, :3] = v / np.linalg.norm(v)
            center[i, 3] = 0.0
        else:
            center[i, :3] = np.linalg.solve(P[i, :, :3], -P[i, :, 3])

    # Camera frame (camera.cpp:122-126)
    zaxis = oaxis[:, :3]
    xaxis = P[:, 0, :3]
    yaxis = np.cross(zaxis, xaxis)
    yaxis /= np.linalg.norm(yaxis, axis=1, keepdims=True)
    xaxis = np.cross(yaxis, zaxis)

    ipscale = (np.linalg.norm(P[:, 0, :3], axis=1)
               + np.linalg.norm(P[:, 1, :3], axis=1)) / 2.0
    ipscale = np.where(ipscale == 0.0, 1.0, ipscale)

    # optim.cpp:55-63: fx + fy with the *unit* camera-frame axes
    ipscale_optim = (np.einsum("nk,nk->n", xaxis, P[:, 0, :3])
                     + np.einsum("nk,nk->n", yaxis, P[:, 1, :3]))

    return CameraSet(
        P=jnp.asarray(P, dtype),
        center=jnp.asarray(center, dtype),
        oaxis=jnp.asarray(oaxis, dtype),
        xaxis=jnp.asarray(xaxis, dtype),
        yaxis=jnp.asarray(yaxis, dtype),
        zaxis=jnp.asarray(zaxis, dtype),
        ipscale=jnp.asarray(ipscale, dtype),
        ipscale_optim=jnp.asarray(ipscale_optim, dtype),
    )


def level_projection(P, level):
    """Rows 0-1 divided by 2^level (reference camera.cpp:56-68).

    `level` may be a traced integer (per-view adaptive levels)."""
    scale = (2.0 ** jnp.asarray(level, P.dtype))
    if jnp.ndim(scale) == 0:
        div = jnp.concatenate([jnp.full((2,), scale, P.dtype),
                               jnp.ones((1,), P.dtype)])
    else:
        div = jnp.stack([scale, scale, jnp.ones_like(scale)], axis=-1)
    return P / div[..., :, None]


def mult(P, coord, level=0):
    """Raw projective product, no divide (reference camera.hpp:110-117)."""
    return jnp.einsum("...ij,...j->...i", level_projection(P, level), coord,
                      precision=HIGHEST)


def project(P, coord, level=0):
    """Pinhole projection with behind-camera sentinel
    (reference camera.hpp:89-108). Broadcasts over leading dims."""
    v = mult(P, coord, level)
    z = v[..., 2:3]
    bad = z <= 0.0
    safe_z = jnp.where(bad, 1.0, z)
    out = v / safe_z
    out = jnp.clip(out, -_CLIP, _CLIP)
    sentinel = jnp.stack([
        jnp.full(out.shape[:-1], PROJ_SENTINEL, out.dtype),
        jnp.full(out.shape[:-1], PROJ_SENTINEL, out.dtype),
        jnp.full(out.shape[:-1], -1.0, out.dtype)], axis=-1)
    return jnp.where(bad, sentinel, out)


def project_level(cams: CameraSet, index, coord, level=0):
    """Project through camera `index` (gathered), batched over coord."""
    return project(cams.P[index], coord, level)


def depth_along_axis(cams: CameraSet, index, coord):
    """Depth along the optical axis: oaxis . coord
    (reference camera.cpp:445-452, perspective branch)."""
    return jnp.einsum("...j,...j->...", cams.oaxis[index], coord,
                      precision=HIGHEST)


def get_unit(cams: CameraSet, index, coord, level):
    """Footprint of one pixel at `coord` in camera `index`
    (reference source/pmvs/optim.cpp:1116-1124)."""
    fz = jnp.linalg.norm(coord[..., :3] - cams.center[index][..., :3],
                         axis=-1)
    ipscale = cams.ipscale_optim[index]
    unit = 2.0 * fz * (2.0 ** level) / jnp.where(ipscale == 0.0, 1.0, ipscale)
    return jnp.where(ipscale == 0.0, 1.0, unit)


def get_paxes(cams: CameraSet, index, coord, normal, level):
    """Patch tangent frame scaled to ~1 pixel steps in the reference view
    (reference source/pmvs/optim.cpp:1127-1144).

    Returns (pxaxis[...,4], pyaxis[...,4]) with w = 0.
    """
    pscale = get_unit(cams, index, coord, level)
    normal3 = normal[..., :3]
    xaxis_cam = cams.xaxis[index]
    yaxis3 = jnp.cross(normal3, xaxis_cam)
    yaxis3 = yaxis3 / jnp.linalg.norm(yaxis3, axis=-1, keepdims=True)
    xaxis3 = jnp.cross(yaxis3, normal3)

    zeros = jnp.zeros(xaxis3.shape[:-1] + (1,), coord.dtype)
    pxaxis = jnp.concatenate([xaxis3, zeros], axis=-1) * pscale[..., None]
    pyaxis = jnp.concatenate([yaxis3, zeros], axis=-1) * pscale[..., None]

    Pl = cams.P[index]
    pc = project(Pl, coord, level)
    xdis = jnp.linalg.norm(project(Pl, coord + pxaxis, level) - pc, axis=-1)
    ydis = jnp.linalg.norm(project(Pl, coord + pyaxis, level) - pc, axis=-1)
    xdis = jnp.where(xdis == 0.0, 1.0, xdis)
    ydis = jnp.where(ydis == 0.0, 1.0, ydis)
    return pxaxis / xdis[..., None], pyaxis / ydis[..., None]


def fundamental_matrix(P0, P1, level=0):
    """F such that x1' F^T x0 = 0 for matching (x0 in cam0, x1 in cam1),
    built from 4x4 determinants of projection rows
    (reference include/image/camera.hpp:129-151).

    Matches the reference setF(lhs=cam0, rhs=cam1): the epipolar line of a
    point p0 in image 1 is `transpose(F) @ p0` (reference seed.cpp:220) and
    the distance gate uses computeEPD(F, p0, p1) = |unit(F p1) . p0|.
    """
    p0 = level_projection(P0, level)
    p1 = level_projection(P1, level)
    p0, p1 = jnp.broadcast_arrays(p0, p1)
    rows0 = [p0[..., 0, :], p0[..., 1, :], p0[..., 2, :]]
    rows1 = [p1[..., 0, :], p1[..., 1, :], p1[..., 2, :]]
    # index pairs for lhs rows: F[i] uses rows0 excluding i in cyclic order
    idx0 = [(1, 2), (2, 0), (0, 1)]
    idx1 = [(1, 2), (2, 0), (0, 1)]
    cols = []
    for a, b in idx0:
        row = []
        for c, d in idx1:
            m = jnp.stack([rows0[a], rows0[b], rows1[c], rows1[d]], axis=-2)
            row.append(jnp.linalg.det(m))
        cols.append(jnp.stack(row, axis=-1))
    return jnp.stack(cols, axis=-2)


def epipolar_distance(F, p0, p1):
    """Symmetric-free epipolar distance |unit(F p1) . p0|
    (reference include/image/camera.hpp:119-127)."""
    line = jnp.einsum("...ij,...j->...i", F, p1, precision=HIGHEST)
    ftmp = jnp.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
    safe = jnp.where(ftmp == 0.0, 1.0, ftmp)
    d = jnp.abs(jnp.einsum("...i,...i->...", line / safe[..., None], p0,
                           precision=HIGHEST))
    return jnp.where(ftmp == 0.0, 0.0, d)


def triangulate_dlt(P0l, P1l, icoord0, icoord1):
    """Two-view DLT triangulation via 3x3 normal equations
    (reference source/pmvs/seed.cpp:340-384).

    P0l/P1l are level-adjusted 3x4 projections; icoord* are [..., 2] pixel
    coords at that level. Returns homogeneous [..., 4] points.
    """
    def rows(P, ic):
        # A_k = P[k] - ic[k] * P[2], k in {0, 1}
        r0 = P[..., 0, :] - ic[..., 0:1] * P[..., 2, :]
        r1 = P[..., 1, :] - ic[..., 1:2] * P[..., 2, :]
        return r0, r1

    a0, a1 = rows(P0l, icoord0)
    a2, a3 = rows(P1l, icoord1)
    a0, a1, a2, a3 = jnp.broadcast_arrays(a0, a1, a2, a3)
    A4 = jnp.stack([a0, a1, a2, a3], axis=-2)   # [..., 4, 4]
    A = A4[..., :3]
    b = -A4[..., 3]
    ATA = jnp.einsum("...ki,...kj->...ij", A, A, precision=HIGHEST)
    ATb = jnp.einsum("...ki,...k->...i", A, b, precision=HIGHEST)
    x = jnp.linalg.solve(ATA, ATb[..., None])[..., 0]
    ones = jnp.ones(x.shape[:-1] + (1,), x.dtype)
    return jnp.concatenate([x, ones], axis=-1)


def unproject(P, icoord, level=0):
    """Invert projection at a given depth encoding: solve
    P[:, :3] X = icoord - P[:, 3] (reference camera.cpp:505-517).
    icoord is [..., 3] with the third component scaling depth."""
    Pl = level_projection(P, level)
    A = Pl[..., :, :3]
    b = icoord - Pl[..., :, 3]
    x = jnp.linalg.solve(A, b[..., None])[..., 0]
    ones = jnp.ones(x.shape[:-1] + (1,), x.dtype)
    return jnp.concatenate([x, ones], axis=-1)
