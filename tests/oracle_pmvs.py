"""Sequential reference-semantics PMVS oracle (numpy + scipy).

A literal, order-faithful re-implementation of the reference's seed +
expand loop for tiny scenes, used to pin the engine's batched wave
semantics to the sequential algorithm at the AGGREGATE level
(SURVEY.md section 7: the priority queue / first-2-successes /
mutable-counter rules are order-dependent, so clouds are compared by
completeness/accuracy, not patch-for-patch).

Mirrored decisions (reference file:line):
- seeding: per-cell feature walk, canAdd occupancy + attempt counters
  (countThreshold2 = 2), epipolar 2px candidate gathering over tau best
  views, DLT triangulation, ddiff ordering, first countThreshold0 = 2
  successes keep the best patch (seed.cpp:133-205, 271-384).
- pipeline: preProcess view selection (visdata + 60 deg facing cone,
  INCC constraint at ncc-0.3), min-image and angle gates, 3-DOF
  refinement of my_f (here scipy Powell instead of nlopt BOBYQA -
  both derivative-free on the same objective, optim.cpp:507-707),
  postProcess constraint at full threshold, 60 deg incidence filter,
  reference re-pick by min summed pairwise robust INCC
  (optim.cpp:95-254).
- expansion: priority queue ordered by score2, 6-sector empty-block
  test over the annulus [r/6, 2.5r], checkCounts cell gates
  (countThreshold1), updateCounts, re-queue iff an empty cell was
  covered, dflag direction bits (expand.cpp:80-323).

Deliberate scope cuts (documented so the comparison stays honest): no
masks/edges/bounds (the synthetic scenes have none), level 0 grabs with
no per-view octave adaptation (footprints are ~1 px at oracle scale),
no vimages (depth-map visibility discovery), no filters (the engine
comparison runs with filters=False).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np
from scipy.optimize import minimize

ASCALE = math.pi / 48.0
ANGLE_BOUND = 23.99999
COS60 = 0.5


# ---------------------------------------------------------------- cameras
class OCams:
    """Numpy mirror of geom.cameras.build_camera_set (f64)."""

    def __init__(self, P: np.ndarray):
        P = np.asarray(P, np.float64).reshape(-1, 3, 4)
        self.P = P
        n = P.shape[0]
        oaxis = P[:, 2, :].copy()
        oaxis /= np.linalg.norm(oaxis[:, :3], axis=1, keepdims=True)
        self.oaxis = oaxis
        self.center = np.ones((n, 4))
        for i in range(n):
            self.center[i, :3] = np.linalg.solve(P[i, :, :3], -P[i, :, 3])
        self.zaxis = oaxis[:, :3]
        xaxis = P[:, 0, :3]
        yaxis = np.cross(self.zaxis, xaxis)
        yaxis /= np.linalg.norm(yaxis, axis=1, keepdims=True)
        self.xaxis = np.cross(yaxis, self.zaxis)
        self.yaxis = yaxis
        self.ipscale_optim = (np.einsum("nk,nk->n", self.xaxis, P[:, 0, :3])
                              + np.einsum("nk,nk->n", self.yaxis,
                                          P[:, 1, :3]))

    def project(self, i: int, X):
        q = self.P[i] @ X
        if q[2] <= 0.0:
            return None
        return q[:2] / q[2]

    def unit(self, i: int, X):
        fz = np.linalg.norm(X[:3] - self.center[i, :3])
        return 2.0 * fz / self.ipscale_optim[i]

    def paxes(self, i: int, X, normal):
        """getPAxes: tangent frame scaled to ~1px (optim.cpp:1127-1144)."""
        pscale = self.unit(i, X)
        n3 = normal[:3]
        y3 = np.cross(n3, self.xaxis[i])
        y3 /= np.linalg.norm(y3)
        x3 = np.cross(y3, n3)
        px = np.append(x3, 0.0) * pscale
        py = np.append(y3, 0.0) * pscale
        pc = self.project(i, X)
        for ax in (px, py):
            pr = self.project(i, X + ax)
            d = np.linalg.norm(pr - pc) if pr is not None else 1.0
            ax /= (d if d != 0.0 else 1.0)
        return px, py

    def fundamental(self, i: int, j: int):
        p0, p1 = self.P[i], self.P[j]
        idx = [(1, 2), (2, 0), (0, 1)]
        F = np.zeros((3, 3))
        for a, (r0, r1) in enumerate(idx):
            for b, (s0, s1) in enumerate(idx):
                F[a, b] = np.linalg.det(
                    np.stack([p0[r0], p0[r1], p1[s0], p1[s1]]))
        return F


def epd(F, p0, p1):
    line = F @ p1
    nrm = math.hypot(line[0], line[1])
    if nrm == 0.0:
        return 0.0
    return abs(np.dot(line / nrm, p0))


def triangulate(P0, P1, ic0, ic1):
    rows = []
    for P, ic in ((P0, ic0), (P1, ic1)):
        rows.append(P[0] - ic[0] * P[2])
        rows.append(P[1] - ic[1] * P[2])
    A4 = np.stack(rows)
    A, b = A4[:, :3], -A4[:, 3]
    x = np.linalg.solve(A.T @ A, A.T @ b)
    return np.append(x, 1.0)


# ------------------------------------------------------------------ texture
def grab(img, c2, dx2, dy2, wsize: int):
    """Bilinear wsize x wsize x 3 window; None on boundary failure
    (grabTex + grabSafe margin 3, optim.cpp:783-862)."""
    h, w = img.shape[:2]
    m = wsize // 2
    span = (np.abs(dx2) + np.abs(dy2)) * m
    mn, mx = c2 - span, c2 + span
    if (mn[0] < 3 or mn[1] < 3 or mx[0] >= w - 4 or mx[1] >= h - 4):
        return None
    gy, gx = np.mgrid[-m:m + 1, -m:m + 1]
    xs = c2[0] + gx * dx2[0] + gy * dy2[0]
    ys = c2[1] + gx * dx2[1] + gy * dy2[1]
    x0 = np.floor(xs).astype(int)
    y0 = np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    out = np.zeros(xs.shape + (3,))
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            out += wgt[..., None] * img[y0 + dy, x0 + dx].astype(float)
    return out.reshape(-1)


def normalize_tex(t):
    t = t - t.mean()
    n = np.linalg.norm(t)
    return t / n * math.sqrt(len(t)) if n > 0 else t


def robustincc(x):
    return x / (1.0 + 3.0 * x)


def unrobustincc(x):
    return x / (1.0 - 3.0 * x)


# -------------------------------------------------------------------- oracle
@dataclass
class OPatch:
    coord: np.ndarray
    normal: np.ndarray
    ncc: float
    images: list = field(default_factory=list)   # [0] = reference
    dflag: int = 0
    dscale: float = 0.0
    ascale: float = 0.0

    def score2(self, thr):
        return max(0.0, self.ncc - thr) * len(self.images)


class OraclePMVS:
    def __init__(self, images, Ps, *, csize=2, wsize=7, threshold=0.7,
                 min_image_num=3, tau=None):
        self.images = [np.asarray(im) for im in images]
        self.cams = OCams(np.stack(Ps))
        self.n = len(images)
        self.tn = self.n
        self.csize, self.wsize = csize, wsize
        self.thr = threshold
        self.min_image_num = min_image_num
        self.tau = tau or min(2 * min_image_num, self.n)
        h, w = self.images[0].shape[:2]
        self.gw = (w + csize - 1) // csize
        self.gh = (h + csize - 1) // csize
        # per (image, cell) state
        self.pgrids = [[[] for _ in range(self.gw * self.gh)]
                       for _ in range(self.n)]
        self.counts = np.zeros((self.n, self.gh * self.gw), np.int32)
        self.patches: list[OPatch] = []
        # pairwise view distances (photoSetS.cpp:195-235)
        c = self.cams.center[:, :3]
        d = np.linalg.norm(c[:, None] - c[None], axis=-1)
        off = ~np.eye(self.n, dtype=bool)
        d = d / d[off].mean()
        ax = self.cams.oaxis[:, :3]
        d += np.maximum(0.0, 1.0 - ax @ ax.T - math.cos(math.radians(10)))
        self.distances = d
        self._F = {}

    def F(self, i, j):
        if (i, j) not in self._F:
            self._F[(i, j)] = self.cams.fundamental(i, j)
        return self._F[(i, j)]

    def cell(self, i, x, y):
        cx = min(max(int(math.floor(x + 0.5)) // self.csize, 0),
                 self.gw - 1)
        cy = min(max(int(math.floor(y + 0.5)) // self.csize, 0),
                 self.gh - 1)
        return cy * self.gw + cx

    def collect_images(self, ref):
        """collectImages (optim.cpp:66-93): 60 deg axis cone, sorted by
        distance, tau cap (visdata all-true here)."""
        cand = []
        for i in range(self.n):
            if i == ref:
                continue
            if np.dot(self.cams.oaxis[ref, :3],
                      self.cams.oaxis[i, :3]) < COS60:
                continue
            cand.append((self.distances[ref, i], i))
        cand.sort()
        return [i for _, i in cand[:self.tau - 1]]

    # ---------------------------------------------------------- pipeline
    def grab_view(self, i, coord, px, py):
        c2 = self.cams.project(i, coord)
        if c2 is None:
            return None
        dx = self.cams.project(i, coord + px)
        dy = self.cams.project(i, coord + py)
        if dx is None or dy is None:
            return None
        return grab(self.images[i], c2, dx - c2, dy - c2, self.wsize)

    def incc_views(self, coord, normal, ref, views):
        """Per-view robust INCC vs the reference window (my_f inner)."""
        px, py = self.cams.paxes(ref, coord, normal)
        tref = self.grab_view(ref, coord, px, py)
        if tref is None:
            return None
        tref = normalize_tex(tref)
        out = {}
        for i in views:
            if i == ref:
                continue
            t = self.grab_view(i, coord, px, py)
            if t is None:
                out[i] = 2.0
                continue
            t = normalize_tex(t)
            ncc = float(tref @ t) / len(tref)
            out[i] = robustincc(1.0 - ncc)
        return out

    def my_f(self, p, prob):
        coord, normal = self.decode(p, prob)
        inccs = self.incc_views(coord, normal, prob["ref"], prob["views"])
        if inccs is None:
            return 2.0
        good = [v for v in inccs.values() if v < 2.0]
        if len(good) < min(self.min_image_num, len(prob["views"])) - 1:
            return 2.0
        return float(np.mean(good)) if good else 2.0

    def encode(self, coord, normal, prob):
        ref = prob["ref"]
        p0 = float(np.dot(coord - prob["center"], prob["ray"])
                   / prob["dscale"])
        fx = np.dot(self.cams.xaxis[ref], normal[:3])
        fy = np.dot(self.cams.yaxis[ref], normal[:3])
        fz = np.dot(self.cams.zaxis[ref], normal[:3])
        b = math.asin(max(-1.0, min(1.0, fy)))
        cosb = math.cos(b)
        if cosb == 0.0:
            a = 0.0
        else:
            sina = fx / cosb
            cosa = -fz / cosb
            a = math.acos(max(-1.0, min(1.0, cosa)))
            if sina < 0.0:
                a = -a
        return np.array([p0, a / ASCALE, b / ASCALE])

    def decode(self, p, prob):
        ref = prob["ref"]
        coord = prob["center"] + prob["dscale"] * p[0] * prob["ray"]
        a1, a2 = p[1] * ASCALE, p[2] * ASCALE
        fx = math.sin(a1) * math.cos(a2)
        fy = math.sin(a2)
        fz = -math.cos(a1) * math.cos(a2)
        n3 = (self.cams.xaxis[ref] * fx + self.cams.yaxis[ref] * fy
              + self.cams.zaxis[ref] * fz)
        return coord, np.append(n3, 0.0)

    def set_scales(self, coord, views):
        ref = views[0]
        unit = self.cams.unit(ref, coord)
        unit2 = 2.0 * unit
        ray = coord - self.cams.center[ref]
        ray /= np.linalg.norm(ray[:3])
        moves = []
        for i in views[1:]:
            pa = self.cams.project(i, coord)
            pb = self.cams.project(i, coord - ray * unit2)
            if pa is not None and pb is not None:
                moves.append(np.linalg.norm(pa - pb))
        dmove = np.mean(moves) if moves else 1.0
        dscale = unit2 / (dmove if dmove != 0.0 else 1.0)
        ascale = math.atan(dscale / (unit * self.wsize / 2.0))
        return dscale, ascale

    def run_pipeline(self, coord, normal, ref, init_views):
        """preProcess -> refine -> postProcess (optim.cpp:95-254).
        Returns an OPatch or None."""
        # addImages: all views facing the patch within 60 deg
        views = set(init_views) | {ref}
        for i in range(self.n):
            ray = self.cams.center[i] - coord
            ray = ray[:3] / np.linalg.norm(ray[:3])
            if np.dot(ray, normal[:3]) >= COS60:
                views.add(i)
        views = sorted(views - {ref},
                       key=lambda i: self.distances[ref, i])
        # constraintImages at ncc - 0.3 (optim.cpp:192-206)
        inccs = self.incc_views(coord, normal, ref, views)
        if inccs is None:
            return None
        thr_b = robustincc(1.0 - (self.thr - 0.3))
        views = [i for i in views if inccs[i] < thr_b]
        if 1 + len(views) < self.min_image_num:
            return None
        ordered = [ref] + views
        dscale, ascale = self.set_scales(coord, ordered[:self.tau])

        prob = {"ref": ref, "center": coord.copy(),
                "ray": (coord - self.cams.center[ref])
                / np.linalg.norm((coord - self.cams.center[ref])[:3]),
                "dscale": dscale, "views": ordered[:self.tau]}
        p0 = self.encode(coord, normal, prob)
        p0[1:] = np.clip(p0[1:], -ANGLE_BOUND, ANGLE_BOUND)
        res = minimize(self.my_f, p0, args=(prob,), method="Powell",
                       bounds=[(None, None), (-ANGLE_BOUND, ANGLE_BOUND),
                               (-ANGLE_BOUND, ANGLE_BOUND)],
                       options={"maxfev": 200, "xtol": 1e-4})
        coord, normal = self.decode(res.x, prob)

        # postProcess: constraint at full threshold + 60 deg incidence
        views = set(prob["views"]) | {ref}
        for i in range(self.n):
            ray = self.cams.center[i] - coord
            ray = ray[:3] / np.linalg.norm(ray[:3])
            if np.dot(ray, normal[:3]) >= COS60:
                views.add(i)
        views = sorted(views, key=lambda i: self.distances[ref, i]
                       if i != ref else -1.0)
        inccs = self.incc_views(coord, normal, ref, views)
        if inccs is None:
            return None
        thr_f = robustincc(1.0 - self.thr)
        keep = [ref] + [i for i in views
                        if i != ref and inccs[i] < thr_f]
        if len(keep) < self.min_image_num:
            return None
        # reference re-pick: min summed pairwise robust INCC among
        # target images (optim.cpp:208-254); with all-target clusters
        # the initial ref is usually optimal - keep ref (deviation:
        # re-pick needs the full pairwise matrix; aggregate-neutral on
        # synthetic scenes where windows are near-identical)
        good = [inccs[i] for i in keep if i != ref]
        score = float(np.mean(good))
        ncc = 1.0 - unrobustincc(score)
        if ncc <= self.thr:
            return None
        pat = OPatch(coord=coord, normal=normal, ncc=ncc, images=keep,
                     dscale=dscale, ascale=ascale)
        return pat

    def add_patch(self, pat: OPatch):
        self.patches.append(pat)
        for i in pat.images:
            c2 = self.cams.project(i, pat.coord)
            if c2 is not None:
                self.pgrids[i][self.cell(i, c2[0], c2[1])].append(pat)

    # -------------------------------------------------------------- seed
    def run_seed(self, feats, count_threshold0=2, count_threshold2=2,
                 ep_threshold=2.0):
        """initialMatch walk (seed.cpp:133-205). feats: per image list of
        (x, y, response, type), response-descending."""
        for ref in range(self.tn):
            others = self.collect_images(ref)
            # bucket features by cell
            buckets = {}
            for (x, y, resp, typ) in feats[ref]:
                buckets.setdefault(self.cell(ref, x, y), []).append(
                    (resp, x, y, typ))
            for cidx in sorted(buckets):
                for resp, x, y, typ in sorted(buckets[cidx],
                                              reverse=True):
                    # canAdd (seed.cpp:325-338)
                    if self.pgrids[ref][cidx]:
                        break
                    if self.counts[ref, cidx] >= count_threshold2:
                        break
                    p0 = np.array([x, y, 1.0])
                    cands = []
                    for j in others:
                        Fm = self.F(ref, j)
                        for (x1, y1, r1, t1) in feats[j]:
                            if t1 != typ:
                                continue
                            p1 = np.array([x1, y1, 1.0])
                            if epd(Fm, p0, p1) > ep_threshold:
                                continue
                            X = triangulate(self.cams.P[ref],
                                            self.cams.P[j],
                                            p0[:2], p1[:2])
                            q = self.cams.P[ref] @ X
                            if q[2] <= 0.0:
                                continue
                            d0 = np.linalg.norm(
                                X[:3] - self.cams.center[ref, :3])
                            d1 = np.linalg.norm(
                                X[:3] - self.cams.center[j, :3])
                            cands.append((abs(d0 - d1), j, X))
                    cands.sort(key=lambda c: c[0])
                    self.counts[ref, cidx] += 1
                    successes = []
                    for _, j, X in cands:
                        normal = self.cams.center[ref] - X
                        normal = np.append(
                            normal[:3] / np.linalg.norm(normal[:3]), 0.0)
                        pat = self.run_pipeline(X, normal, ref, [j])
                        if pat is not None:
                            successes.append(pat)
                            if len(successes) >= count_threshold0:
                                break
                    if successes:
                        best = max(successes, key=lambda p: p.ncc)
                        self.add_patch(best)

    # ------------------------------------------------------------ expand
    def run_expand(self, count_threshold1=4, slack=0, max_pops=20000):
        """Queue drain (expand.cpp:73-106)."""
        heap = []
        seq = 0
        for pat in self.patches:
            heapq.heappush(heap, (-pat.score2(self.thr), seq, pat))
            seq += 1
        pops = 0
        while heap and pops < max_pops:
            _, _, pat = heapq.heappop(heap)
            pops += 1
            ref = pat.images[0]
            units = sorted(self.cams.unit(i, pat.coord)
                           for i in pat.images)
            radius = (units[1] if len(units) > 1 else units[0]) \
                * self.csize
            px, py = self._ortho(pat.normal)
            # neighbor fill per sector over the annulus [r/6, 2.5r]
            fills = np.zeros(6)
            for q in self._neighbors(pat, radius):
                d = q.coord[:3] - pat.coord[:3]
                fx, fy = np.dot(d, px[:3]), np.dot(d, py[:3])
                ln = math.hypot(fx, fy)
                if ln < radius / 6.0 or ln > radius * 2.5:
                    continue
                ang = math.atan2(fy, fx)
                if ang < 0.0:
                    ang += 2 * math.pi
                find = ang / (2 * math.pi / 6.0)
                lo = int(math.floor(find))
                fills[lo % 6] += (lo + 1) - find
                fills[(lo + 1) % 6] += find - lo
            for s in range(6):
                if fills[s] > 0.0 or (pat.dflag >> s) & 1:
                    continue
                ang = 2 * math.pi * s / 6.0
                cand = (pat.coord
                        + (math.cos(ang) * px + math.sin(ang) * py)
                        * radius)
                # checkCounts (expand.cpp:258-323)
                full = empty = 0
                cells = []
                for i in pat.images:
                    c2 = self.cams.project(i, cand)
                    if c2 is None:
                        continue
                    cidx = self.cell(i, c2[0], c2[1])
                    cells.append((i, cidx))
                    if (self.pgrids[i][cidx]
                            or self.counts[i, cidx] >= count_threshold1):
                        full += 1
                    else:
                        empty += 1
                if not cells:
                    pat.dflag |= 1 << s
                    continue
                if empty < self.min_image_num - slack and full != 0:
                    pat.dflag |= 1 << s
                    continue
                newp = self.run_pipeline(cand, pat.normal.copy(), ref,
                                         list(pat.images[1:]))
                covered_empty = any(
                    not self.pgrids[i][c] for i, c in cells)
                for i, c in cells:
                    self.counts[i, c] += 1
                if newp is None:
                    pat.dflag |= 1 << s
                    continue
                self.add_patch(newp)
                if covered_empty:
                    heapq.heappush(
                        heap, (-newp.score2(self.thr), seq, newp))
                    seq += 1

    def _ortho(self, normal):
        z = normal[:3]
        if abs(z[0]) > 0.5:
            x = np.array([z[1], -z[0], 0.0])
        elif abs(z[1]) > 0.5:
            x = np.array([0.0, z[2], -z[1]])
        else:
            x = np.array([-z[2], 0.0, z[0]])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        return np.append(x, 0.0), np.append(y, 0.0)

    def _neighbors(self, pat, radius):
        """All patches within 2.5r (brute force - oracle scenes are
        tiny; replaces the 3x3 cell-window walk)."""
        out = []
        for q in self.patches:
            if q is pat:
                continue
            if np.linalg.norm(
                    q.coord[:3] - pat.coord[:3]) <= 2.5 * radius * 1.5:
                out.append(q)
        return out

    # ------------------------------------------------------------ filters
    def _rebuild_grids(self):
        self.pgrids = [[[] for _ in range(self.gw * self.gh)]
                       for _ in range(self.n)]
        for pat in self.patches:
            for i in pat.images:
                c2 = self.cams.project(i, pat.coord)
                if c2 is not None:
                    self.pgrids[i][self.cell(i, c2[0], c2[1])].append(
                        pat)

    def _is_nb2(self, p, q):
        """2-arg isNeighbor (findMatch.cpp:120-185): hunit = mean of
        the two reference 1-px units x csize, threshold neighbor1=1."""
        if float(p.normal[:3] @ q.normal[:3]) \
                < math.cos(math.radians(120.0)):
            return False
        diff = q.coord - p.coord
        vunit = p.dscale + q.dscale
        f0 = float(p.normal @ diff)
        f1 = float(q.normal @ diff)
        ftmp = (abs(f0) + abs(f1)) / 2.0 / (vunit if vunit else 1.0)
        hunit = (self.cams.unit(p.images[0], p.coord)
                 + self.cams.unit(q.images[0], q.coord)) / 2.0 \
            * self.csize
        hvec = 2.0 * diff - p.normal * f0 - q.normal * f1
        hsize = np.linalg.norm(hvec[:3]) / 2.0 / hunit
        if hsize > 1.0:
            ftmp /= min(2.0, hsize)
        return ftmp < 1.0

    def filter_outside(self):
        """Gain pass (filter.cpp:29-201): gain = score2 minus, per
        occupied cell, the strongest non-neighbor co-cell pressure
        max(0, ncc_q - thr). pgrids only (the oracle has no vimages -
        documented scope cut); one pass like the engine's stage."""
        keep = []
        for pat in self.patches:
            gain = pat.score2(self.thr)
            for i in pat.images:
                c2 = self.cams.project(i, pat.coord)
                if c2 is None:
                    continue
                best = 0.0
                for q in self.pgrids[i][self.cell(i, c2[0], c2[1])]:
                    if q is pat or self._is_nb2(pat, q):
                        continue
                    best = max(best, q.ncc - self.thr)
                gain -= max(best, 0.0)
            if gain >= 0.0:
                keep.append(pat)
        self.patches = keep
        self._rebuild_grids()

    def _facing_units(self, pat):
        """Per-view fineness units with the facing denominator
        (reference optim.cpp:446-471)."""
        out = []
        for i in pat.images:
            ray = self.cams.center[i] - pat.coord
            ray = ray[:3] / np.linalg.norm(ray[:3])
            denom = float(ray @ pat.normal[:3])
            if denom <= 0.0:
                out.append(np.inf)
            else:
                out.append(self.cams.unit(i, pat.coord) / denom)
        return sorted(out)

    def filter_neighbor(self, quad=2.5, neighbor=0.5, cell_k=16):
        """Quadric-fit neighborhood pass (filter.cpp:357-462 +
        patchOrganizerS.cpp:528-600): neighbors from the 5x5 cell
        windows of every stored image (self included, duplicates
        kept), reject when cnt < 6 or the scaled quad residual >=
        `quad`. Mirrors the numpy walk parity-tested against the
        engine in tests/test_filter_neighbor.py."""
        units_sorted = {}
        keep = []
        thr_n = neighbor * 4.0
        for pat in self.patches:
            fu = self._facing_units(pat)
            radius = (fu[1] if len(fu) > 1 else fu[0]) * self.csize \
                * 1.5 * 2.0
            unit_list = [self.cams.unit(i, pat.coord)
                         for i in pat.images[:self.tau]]
            unit_n = float(np.mean(unit_list)) * self.csize
            u_res = float(np.mean(unit_list))

            nbs = []
            for i in pat.images:
                c2 = self.cams.project(i, pat.coord)
                if c2 is None:
                    continue
                cx0 = min(max(int(math.floor(c2[0] + 0.5))
                              // self.csize, 0), self.gw - 1)
                cy0 = min(max(int(math.floor(c2[1] + 0.5))
                              // self.csize, 0), self.gh - 1)
                for oy in range(-2, 3):
                    for ox in range(-2, 3):
                        cx, cy = cx0 + ox, cy0 + oy
                        if not (0 <= cx < self.gw and 0 <= cy < self.gh):
                            continue
                        occ = self.pgrids[i][cy * self.gw + cx]
                        for q in occ[:cell_k]:
                            if self._is_nb_radius(pat, q, unit_n,
                                                  radius, thr_n):
                                nbs.append(q)
            cnt = len(nbs)
            if cnt < 6:
                continue
            diffs = np.stack([q.coord - pat.coord for q in nbs])
            h = float(np.linalg.norm(diffs[:, :3], axis=1).mean())
            h = h if h != 0.0 else 1.0
            xdir, ydir = self._ortho(pat.normal)
            fx = diffs @ xdir / h
            fy = diffs @ ydir / h
            fz = diffs @ pat.normal
            A = np.stack([fx * fx, fy * fy, fx * fy, fx, fy], 1)
            x = np.linalg.solve(A.T @ A + 1e-9 * np.eye(5), A.T @ fz)
            res = float(np.abs(A @ x - fz).sum())
            scaled = res / (u_res if u_res else 1.0) / max(cnt - 5, 1)
            if scaled < quad:
                keep.append(pat)
        self.patches = keep
        self._rebuild_grids()

    def _is_nb_radius(self, p, q, unit_n, radius, thr_n):
        """isNeighborRadius with the findNeighbors vunit
        (dscale sums) and radius gate (filter.cpp:357-462)."""
        if float(p.normal[:3] @ q.normal[:3]) \
                < math.cos(math.radians(120.0)):
            return False
        diff = q.coord - p.coord
        vunit = p.dscale + q.dscale
        f0 = float(p.normal @ diff)
        f1 = float(q.normal @ diff)
        ftmp = (abs(f0) + abs(f1)) / 2.0 / (vunit if vunit else 1.0)
        hvec = 2.0 * diff - p.normal * f0 - q.normal * f1
        hsize = np.linalg.norm(hvec[:3]) / 2.0 / unit_n
        if hsize > radius / unit_n:
            return False
        if hsize > 1.0:
            ftmp /= min(2.0, hsize)
        return ftmp < thr_n

    def run_filters(self, quad=2.5):
        """filterOutside + filterNeighbor (the oracle's filter stage;
        filterExact needs depth maps the oracle deliberately lacks)."""
        self.filter_outside()
        self.filter_neighbor(quad=quad)
