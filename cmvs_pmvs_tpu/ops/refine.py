"""Batched patch refinement: Levenberg-Marquardt over (depth, alpha, beta).

The batched replacement for the reference's per-patch nlopt BOBYQA loop
(reference source/pmvs/optim.cpp:496-658): the same 3-DOF parametrization -
depth offset along the reference-view ray in units of `dscale`, two Euler
angles of the normal in the reference-camera frame in units of pi/48 with
bounds +-23.99999 (optim.cpp:580-707) - and the same robust-INCC objective
`my_f` (optim.cpp:507-578), but minimized for B patches at once by damped
Gauss-Newton with central-difference Jacobians of the per-view sqrt-INCC
residuals. All control flow is mask-based; the whole refine step is one
jittable function.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from ..geom.cameras import HIGHEST, CameraSet, get_unit, project
from ..image.pyramid import PyramidSet
from .texture import grab_tex, ncc_dot, normalize_tex, robustincc, unrobustincc

ASCALE = jnp.pi / 48.0          # optim.cpp:590
ANGLE_BOUND = 23.99999          # optim.cpp:601-602
HUGE = 1.0e10


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RefineProblem:
    """Per-patch constants of one refinement batch.

    views[:, 0] is the reference view (optim.cpp:584-590).
    """

    centers: jax.Array     # [B, 4] patch center at entry
    rays: jax.Array        # [B, 4] unit ray ref-center -> patch (w = 0)
    dscales: jax.Array     # [B]
    views: jax.Array       # [B, T] int32, -1 padded
    view_valid: jax.Array  # [B, T] bool
    weights: jax.Array     # [B, T] INCC weights (optim.cpp:592-596)
    min_image_num: int = field(metadata=dict(static=True))


def encode_params(cams: CameraSet, prob: RefineProblem, coord, normal):
    """(coord, normal) -> [B, 3] scaled params (optim.cpp:660-688)."""
    ref = jnp.maximum(prob.views[:, 0], 0)
    p0 = (jnp.einsum("bk,bk->b", coord - prob.centers, prob.rays,
                     precision=HIGHEST)
          / prob.dscales)
    fx = jnp.einsum("bk,bk->b", cams.xaxis[ref], normal[:, :3],
                    precision=HIGHEST)
    fy = jnp.einsum("bk,bk->b", cams.yaxis[ref], normal[:, :3],
                    precision=HIGHEST)
    fz = jnp.einsum("bk,bk->b", cams.zaxis[ref], normal[:, :3],
                    precision=HIGHEST)
    p2 = jnp.arcsin(jnp.clip(fy, -1.0, 1.0))
    cosb = jnp.cos(p2)
    safe_cosb = jnp.where(cosb == 0.0, 1.0, cosb)
    sina = fx / safe_cosb
    cosa = -fz / safe_cosb
    p1 = jnp.arccos(jnp.clip(cosa, -1.0, 1.0))
    p1 = jnp.where(sina < 0.0, -p1, p1)
    p1 = jnp.where(cosb == 0.0, 0.0, p1)
    return jnp.stack([p0, p1 / ASCALE, p2 / ASCALE], axis=-1)


def decode_params(cams: CameraSet, prob: RefineProblem, p):
    """[B, 3] params -> (coord [B, 4], normal [B, 4])
    (optim.cpp:690-707)."""
    ref = jnp.maximum(prob.views[:, 0], 0)
    coord = prob.centers + (prob.dscales * p[:, 0])[:, None] * prob.rays
    a1 = p[:, 1] * ASCALE
    a2 = p[:, 2] * ASCALE
    fx = jnp.sin(a1) * jnp.cos(a2)
    fy = jnp.sin(a2)
    fz = -jnp.cos(a1) * jnp.cos(a2)
    n3 = (cams.xaxis[ref] * fx[:, None] + cams.yaxis[ref] * fy[:, None]
          + cams.zaxis[ref] * fz[:, None])
    normal = jnp.concatenate(
        [n3, jnp.zeros(n3.shape[:-1] + (1,), n3.dtype)], axis=-1)
    return coord, normal


def compute_units(cams: CameraSet, level: int, coord, normal, views,
                  view_valid):
    """Per-view fineness units: getUnit / max(ray.normal, 0)
    (reference optim.cpp:446-471); invalid or back-facing -> HUGE."""
    vid = jnp.maximum(views, 0)
    unit = get_unit(cams, vid, coord[:, None, :], level)
    ray = cams.center[vid] - coord[:, None, :]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    denom = jnp.einsum("btk,bk->bt", ray[..., :3], normal[:, :3],
                       precision=HIGHEST)
    fine = jnp.where(denom > 0.0, unit / jnp.where(denom > 0.0, denom, 1.0),
                     HUGE)
    return jnp.where(view_valid, fine, HUGE)


def set_scales(cams: CameraSet, level: int, wsize: int, coord, views,
               view_valid):
    """Per-patch (dscale, ascale) (reference patchOrganizerS.cpp:663-684):
    dscale = depth step along the reference ray that moves the projection
    in the other views by ~1 pixel on average; ascale = atan(dscale /
    (unit * wsize/2)).

    coord: [B, 4]; views: [B, T] (ref at [:, 0]). Averages over the valid
    non-reference views (the reference caps at tau by construction).
    """
    ref = jnp.maximum(views[:, 0], 0)
    unit = get_unit(cams, ref, coord, level)
    unit2 = 2.0 * unit
    ray = coord - cams.center[ref]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)

    vid = jnp.maximum(views, 0)
    P = cams.P[vid]
    pa = project(P, coord[:, None, :], level)
    pb = project(P, (coord - ray * unit2[:, None])[:, None, :], level)
    diff = jnp.linalg.norm((pa - pb)[..., :2], axis=-1)
    m = view_valid.at[:, 0].set(False)
    denom = jnp.maximum(m.sum(axis=-1), 1)
    dmove = jnp.where(m, diff, 0.0).sum(axis=-1) / denom
    dscale = unit2 / jnp.where(dmove == 0.0, 1.0, dmove)
    ascale = jnp.arctan(dscale / (unit * wsize / 2.0))
    return dscale, ascale


def make_problem(cams: CameraSet, level: int, coord, normal, views,
                 view_valid, dscales, min_image_num: int) -> RefineProblem:
    """Set up the batch constants (reference refinePatchBFGS entry,
    optim.cpp:582-596: centers/rays/weights fixed at the initial patch)."""
    ref = jnp.maximum(views[:, 0], 0)
    ray = coord - cams.center[ref]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    units = compute_units(cams, level, coord, normal, views, view_valid)
    w = jnp.minimum(1.0, units[:, 0:1] / jnp.maximum(units, 1e-30))
    w = w.at[:, 0].set(1.0)
    w = jnp.where(view_valid, w, 0.0)
    return RefineProblem(centers=coord, rays=ray, dscales=dscales,
                         views=views, view_valid=view_valid, weights=w,
                         min_image_num=min_image_num)


def _patch_axes(cams: CameraSet, level: int, ref, coord, normal):
    """getPAxes against the reference view (optim.cpp:1127-1144)."""
    pscale = get_unit(cams, ref, coord, level)
    n3 = normal[..., :3]
    y3 = jnp.cross(n3, cams.xaxis[ref])
    y3 = y3 / jnp.linalg.norm(y3, axis=-1, keepdims=True)
    x3 = jnp.cross(y3, n3)
    zeros = jnp.zeros(x3.shape[:-1] + (1,), coord.dtype)
    px = jnp.concatenate([x3, zeros], axis=-1) * pscale[..., None]
    py = jnp.concatenate([y3, zeros], axis=-1) * pscale[..., None]
    P = cams.P[ref]
    pc = project(P, coord, level)
    xdis = jnp.linalg.norm(
        (project(P, coord + px, level) - pc)[..., :2], axis=-1)
    ydis = jnp.linalg.norm(
        (project(P, coord + py, level) - pc)[..., :2], axis=-1)
    px = px / jnp.where(xdis == 0.0, 1.0, xdis)[..., None]
    py = py / jnp.where(ydis == 0.0, 1.0, ydis)[..., None]
    return px, py


def _grab_all(cams, pyr, level, wsize, prob: RefineProblem, coord, normal):
    ref = jnp.maximum(prob.views[:, 0], 0)
    px, py = _patch_axes(cams, level, ref, coord, normal)
    texs, ok = grab_tex(cams, pyr, level, wsize, coord, px, py, normal,
                        prob.views, prob.view_valid)
    texs = normalize_tex(texs, ok)
    return texs, ok


def per_view_inccs(cams, pyr, level, wsize, prob: RefineProblem, coord,
                   normal):
    """Robust INCC of each non-reference view vs the reference window.

    Returns (incc [B, T] with 2.0 at invalid pairs, ref_ok [B],
    pair_ok [B, T]). Mirrors my_f's reference-based branch
    (optim.cpp:556-575)."""
    texs, ok = _grab_all(cams, pyr, level, wsize, prob, coord, normal)
    ref_ok = ok[:, 0]
    dots = ncc_dot(texs[:, 0:1], texs)                   # [B, T]
    incc = robustincc(1.0 - dots)
    pair_ok = ok & ok[:, 0:1]
    pair_ok = pair_ok.at[:, 0].set(False)                # skip i == 0
    incc = jnp.where(pair_ok, incc, 2.0)
    return incc, ref_ok, pair_ok


def incc_objective(cams, pyr, level, wsize, prob: RefineProblem, p,
                   view_axis: str | None = None):
    """The scalar objective my_f (optim.cpp:507-578), batched.

    When `view_axis` is set (inside shard_map), each shard holds the
    reference view in slot 0 plus its slice of the other views; the sum
    and count of per-view INCCs are psum'd over the axis so every shard
    sees the global objective (tensor-parallel views).

    Returns (f [B], incc [B, T_local], pair_ok [B, T_local])."""
    coord, normal = decode_params(cams, prob, p)
    incc, ref_ok, pair_ok = per_view_inccs(cams, pyr, level, wsize, prob,
                                           coord, normal)
    denom = pair_ok.sum(axis=-1)
    nviews = prob.view_valid.sum(axis=-1)
    total = jnp.where(pair_ok, incc, 0.0).sum(axis=-1)
    if view_axis is not None:
        denom = jax.lax.psum(denom, view_axis)
        total = jax.lax.psum(total, view_axis)
        nviews = jax.lax.psum(nviews - 1, view_axis) + 1  # ref counted once
    mininum = jnp.minimum(prob.min_image_num, nviews)
    mean = total / jnp.maximum(denom, 1)
    bad = (~ref_ok) | (denom < mininum - 1)
    f = jnp.where(bad, 2.0, mean)
    return f, incc, pair_ok


def _solve3x3(A, b):
    """Batched closed-form 3x3 solve via the adjugate.

    jnp.linalg.solve lowers to a solver library call per batch; the
    cofactor form is pure fusible elementwise math. A [B, 3, 3] must be
    well-conditioned (callers add Levenberg damping).
    """
    a, b_, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b_ * i
    co02 = b_ * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b_ * g - a * h
    co22 = a * e - b_ * d
    det = a * co00 + b_ * co10 + c * co20
    inv_det = jnp.where(jnp.abs(det) < 1e-30, 0.0, 1.0 / det)
    x0 = (co00 * b[:, 0] + co01 * b[:, 1] + co02 * b[:, 2]) * inv_det
    x1 = (co10 * b[:, 0] + co11 * b[:, 1] + co12 * b[:, 2]) * inv_det
    x2 = (co20 * b[:, 0] + co21 * b[:, 1] + co22 * b[:, 2]) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def refine_patches(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
                   prob: RefineProblem, coord, normal, num_iters: int = 12,
                   active=None, view_axis: str | None = None,
                   with_ncc: bool = True):
    """Damped Gauss-Newton minimization of the robust INCC objective.

    Replaces refinePatchBFGS (optim.cpp:580-658). Returns
    (coord, normal, ncc, final_f): refined geometry, the weighted NCC score
    the reference stores as patch._ncc = 1 - unrobustincc(INCC_weighted)
    (optim.cpp:652), and the final objective value.

    `active`: [B] bool; inactive rows pass through unchanged (they still
    cost compute - callers should compact batches when worthwhile).
    `view_axis`: shard_map axis name for tensor-parallel views; the
    Gauss-Newton normal equations are psum'd over it so all shards take
    identical steps.
    """
    if active is None:
        active = jnp.ones(coord.shape[0], bool)

    p0 = encode_params(cams, prob, coord, normal)
    p0 = p0.at[:, 1:].set(jnp.clip(p0[:, 1:], -ANGLE_BOUND, ANGLE_BOUND))

    def objective(p):
        return incc_objective(cams, pyr, level, wsize, prob, p,
                              view_axis=view_axis)

    def residuals(p):
        f, incc, pair_ok = objective(p)
        # sqrt residuals so sum r^2 == sum incc (GN target == my_f target)
        r = jnp.sqrt(jnp.where(pair_ok, jnp.maximum(incc, 0.0), 0.0) + 1e-8)
        r = jnp.where(pair_ok, r, 0.0)
        return f, r, pair_ok

    f0, r0, _ = residuals(p0)
    h = jnp.asarray([0.4, 0.4, 0.4], p0.dtype)

    # all 6 central-difference probes evaluate as ONE 6x-batched objective
    # call: one kernel instance instead of six (compile time and batch
    # occupancy both improve)
    b = coord.shape[0]
    prob6 = jax.tree_util.tree_map(
        lambda x: jnp.concatenate([x] * 6, axis=0)
        if isinstance(x, jax.Array) and x.ndim >= 1 and x.shape[0] == b
        else x, prob)

    def residuals6(p6):
        f, incc, pair_ok = incc_objective(cams, pyr, level, wsize, prob6,
                                          p6, view_axis=view_axis)
        r = jnp.sqrt(jnp.where(pair_ok, jnp.maximum(incc, 0.0), 0.0)
                     + 1e-8)
        return jnp.where(pair_ok, r, 0.0)

    def step(state, _):
        p, f, r, lam = state
        # central-difference Jacobian of residuals wrt the 3 params
        probes = []
        for k in range(3):
            dp = jnp.zeros_like(p).at[:, k].set(h[k])
            probes.extend([p + dp, p - dp])
        r6 = residuals6(jnp.concatenate(probes, axis=0))
        rs = [r6[i * b:(i + 1) * b] for i in range(6)]
        cols = [(rs[2 * k] - rs[2 * k + 1]) / (2.0 * h[k])
                for k in range(3)]
        J = jnp.stack(cols, axis=-1)                  # [B, T, 3]
        JtJ = jnp.einsum("btk,btl->bkl", J, J, precision=HIGHEST)
        Jtr = jnp.einsum("btk,bt->bk", J, r, precision=HIGHEST)
        if view_axis is not None:
            JtJ = jax.lax.psum(JtJ, view_axis)
            Jtr = jax.lax.psum(Jtr, view_axis)
        damped = JtJ + ((lam + 1e-9)[:, None, None]
                        * jnp.eye(3, dtype=p.dtype)[None])
        delta = _solve3x3(damped, -Jtr)
        delta = jnp.clip(delta, -4.0, 4.0)
        p_new = p + delta
        p_new = p_new.at[:, 1:].set(
            jnp.clip(p_new[:, 1:], -ANGLE_BOUND, ANGLE_BOUND))
        f_new, r_new, _ = residuals(p_new)
        accept = (f_new < f) & active
        p = jnp.where(accept[:, None], p_new, p)
        r = jnp.where(accept[:, None], r_new, r)
        lam = jnp.where(accept, lam * 0.3, lam * 4.0)
        lam = jnp.clip(lam, 1e-5, 1e4)
        f = jnp.where(accept, f_new, f)
        return (p, f, r, lam), None

    # derive from f0 so the initial carry inherits its sharding/vma under
    # shard_map (a literal full() would be replicated and fail the scan
    # carry type check)
    lam0 = jnp.zeros_like(f0) + 1e-3
    (p, f, _, _), _ = jax.lax.scan(step, (p0, f0, r0, lam0),
                                   None, length=num_iters)

    new_coord, new_normal = decode_params(cams, prob, p)
    new_coord = jnp.where(active[:, None], new_coord, coord)
    new_normal = jnp.where(active[:, None], new_normal, normal)
    ncc = compute_weighted_incc(cams, pyr, level, wsize, prob, new_coord,
                                new_normal, view_axis=view_axis) \
        if with_ncc else None
    return new_coord, new_normal, ncc, f


def compute_weighted_incc(cams, pyr, level, wsize, prob: RefineProblem,
                          coord, normal, view_axis: str | None = None):
    """patch._ncc = 1 - unrobustincc(weighted robust INCC)
    (reference optim.cpp:652 + computeINCC :875-938, non-pairwise path)."""
    incc, ref_ok, pair_ok = per_view_inccs(cams, pyr, level, wsize, prob,
                                           coord, normal)
    w = jnp.where(pair_ok, prob.weights, 0.0)
    total = w.sum(axis=-1)
    num = (incc * w).sum(axis=-1)
    if view_axis is not None:
        total = jax.lax.psum(total, view_axis)
        num = jax.lax.psum(num, view_axis)
    score = num / jnp.where(total == 0.0, 1.0, total)
    score = jnp.where((total == 0.0) | (~ref_ok), 2.0, score)
    return 1.0 - unrobustincc(score)
