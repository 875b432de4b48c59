"""CMVS view clustering: the pod-scale partitioner.

Port of CBundle (reference source/cmvs/bundle.cpp, CVPR-2010 CMVS): given
Bundler SfM output, compress SfM points, drop redundant images, split the
remainder into overlapping clusters of <= maximage views, and grow
clusters until every image's points are covered. Outputs ske.dat /
vis.dat / centers-*.ply consumed by genOption + the PMVS engine.

Replacements for vendored third-party code (SURVEY.md section 2.3):
  * STANN z-order kNN        -> scipy cKDTree (host-side, build-time)
  * Graclus MLKKM normalized cut -> spectral bisection by the Fiedler
    vector of the normalized Laplacian (quality matched on cluster-size
    and coverage metrics, not cut-identical)
  * the fork's broken CDisjointSet (unconditional throw,
    disjoint.hpp:117-125) -> a correct union-find

The decision loops are host-side Python/numpy (they are sequential greedy
choices over <=hundreds of images); the scoring kernel computeScore2 is
vectorized per point.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..io.bundler import BundleData, read_bundle
from ..io.cameras import read_camera_txt
from ..io.ske import write_ske
from ..io.visdata import write_vis

LSIGMA = 5.0 * math.pi / 180.0
RSIGMA = 15.0 * math.pi / 180.0
PIVOT = 20.0 * math.pi / 180.0


class UnionFind:
    """Union-find with path compression (replaces the fork's broken
    CDisjointSet, reference include/cmvs/disjoint.hpp)."""

    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def angle_score(cos_angle):
    """Gaussian band-pass around a 20-degree pair angle
    (reference bundle.cpp:956-971)."""
    angle = np.arccos(np.minimum(1.0, cos_angle))
    diff = angle - PIVOT
    sig2 = np.where(angle < PIVOT, 2.0 * LSIGMA * LSIGMA,
                    2.0 * RSIGMA * RSIGMA)
    return np.exp(-diff * diff / sig2)


def pad_lists(lists: list[list[int]], fill: int = -1) -> np.ndarray:
    """Ragged int lists -> [N, Vmax] padded array."""
    vmax = max((len(v) for v in lists), default=0)
    out = np.full((len(lists), max(vmax, 2)), fill, dtype=np.int64)
    for i, v in enumerate(lists):
        out[i, :len(v)] = v
    return out


def pair_scores_batch(centers, ipscales, coords, images, valid,
                      masked: bool = True):
    """Pairwise angleScore x inverse-footprint matrices for B problems.

    coords [B, 3]; images [B, V] (clamped indices); valid [B, V].
    Returns pair [B, V, V] with -inf outside valid pairs / on the
    diagonal (reference bundle.cpp:1253-1296: the greedy set function's
    pairwise term). With masked=False the raw values are returned
    (finite everywhere) for caching; score2_from_pair applies masks.
    """
    rays = (centers[images] - coords[:, None, :]).astype(np.float32)
    dist = np.linalg.norm(rays, axis=-1)
    dist = np.where(dist == 0.0, 1.0, dist)
    rays = rays / dist[..., None]
    scales = (ipscales[images] / dist).astype(np.float32)   # 1/footprint
    cosm = np.einsum("bvk,bwk->bvw", rays, rays)
    pair = angle_score(cosm).astype(np.float32) \
        * scales[:, :, None] * scales[:, None, :]
    if not masked:
        return pair
    ok = valid[:, :, None] & valid[:, None, :]
    v = images.shape[1]
    ok &= ~np.eye(v, dtype=bool)[None]
    return np.where(ok, pair, -np.inf)


def score2_from_pair(pair, valid, tau: int):
    """Greedy tau-subset selection over a precomputed pair matrix
    (the inner loop of computeScore2, bundle.cpp:1290-1325).

    pair [B, V, V] from pair_scores_batch (any superset validity,
    masked or raw); valid [B, V] is the subset to select from. Returns
    (scores [B], chosen [B, tau] slot indices, -1 padded).
    """
    b, v = valid.shape
    ok = valid[:, :, None] & valid[:, None, :]
    ok &= ~np.eye(v, dtype=bool)[None]
    pair = np.where(ok, pair, -np.inf)
    nvalid = valid.sum(axis=1)
    flat = pair.reshape(b, v * v)
    ij = flat.argmax(axis=1)
    i0, j0 = ij // v, ij % v
    rows = np.arange(b)
    best = flat[rows, ij]
    alive = nvalid >= 2
    best = np.where(alive, best, -1.0)

    in_set = np.zeros((b, v), bool)
    in_set[rows, np.where(alive, i0, 0)] = alive
    in_set[rows, np.where(alive, j0, 0)] |= alive
    chosen = np.full((b, max(tau, 2)), -1, dtype=np.int64)
    chosen[alive, 0] = i0[alive]
    chosen[alive, 1] = j0[alive]

    gains = pair[rows, i0] + pair[rows, j0]                 # [B, V]
    for step in range(2, tau):
        g = np.where(in_set | ~valid, -np.inf, gains)
        k = g.argmax(axis=1)
        gk = g[rows, k]
        take = alive & (nvalid > step) & np.isfinite(gk)
        best = np.where(take, best + gk, best)
        chosen[take, step] = k[take]
        in_set[rows[take], k[take]] = True
        gains = np.where(take[:, None], gains + pair[rows, k], gains)
    return best, chosen


def score2_batch(centers, ipscales, coords, images, tau: int,
                 valid=None):
    """Batched computeScore2 (reference bundle.cpp:1248-1325): greedy
    tau-subset score maximizing the pairwise angle/footprint sum.

    images: [B, V] int64, -1 padded. Returns (scores [B], chosen
    [B, tau] slot indices with -1 padding). Rows with < 2 valid images
    score -1.
    """
    if valid is None:
        valid = images >= 0
    img = np.maximum(images, 0)
    pair = pair_scores_batch(centers, ipscales, coords, img, valid)
    return score2_from_pair(pair, valid, tau)


@dataclass
class CmvsProblem:
    coords: np.ndarray         # [P, 3]
    visibles: list[list[int]]  # per point, sorted image ids
    centers: np.ndarray        # [C, 3] optical centers
    ipscales: np.ndarray       # [C] (|P0|+|P1|)/2 for getScale
    widths: np.ndarray         # [C] full-res widths
    heights: np.ndarray        # [C]
    dlevel: int = 7            # SfM resolution level (bundle.cpp:65-66)

    @property
    def cnum(self) -> int:
        return len(self.centers)

    def get_scale(self, coord: np.ndarray, images: np.ndarray,
                  level: int = 0) -> np.ndarray:
        """Pixel footprint of the images at coord
        (reference camera.cpp:178-194)."""
        ray = coord[None, :] - self.centers[images]
        return (np.linalg.norm(ray, axis=1) * (1 << level)
                / self.ipscales[images])


class CmvsClustering:
    """The full clustering pipeline (reference CBundle::run,
    bundle.cpp:120-171)."""

    def __init__(self, prob: CmvsProblem, maximage: int, tau: int = 4,
                 score_ratio: float = 0.7, coverage: float = 0.7,
                 log=print):
        self.prob = prob
        self.maximage = maximage
        self.tau = tau
        self.score_ratio = score_ratio
        self.coverage = coverage
        self.log = log
        self.coords = prob.coords.copy()
        self.visibles = [list(v) for v in prob.visibles]
        self.pweights = np.ones(len(self.coords))
        self.removed = np.zeros(prob.cnum, dtype=bool)
        self.timages: list[list[int]] = []
        self.oimages: list[list[int]] = []

    # ---- scoring (bundle.cpp:1248-1325) ----
    def compute_score2(self, coord, images) -> tuple[float, list[int]]:
        """Greedy tau-subset score: best pair by angleScore x inverse
        footprints, then greedily extend. Returns (score, uimages)."""
        images = np.asarray(images)
        inum = len(images)
        if inum < 2:
            return -1.0, []
        rays = self.prob.centers[images] - coord[None, :]
        rays = rays / np.linalg.norm(rays, axis=1, keepdims=True)
        scales = 1.0 / self.prob.get_scale(coord, images)
        cosm = rays @ rays.T
        pair = angle_score(cosm) * scales[:, None] * scales[None, :]
        np.fill_diagonal(pair, -np.inf)
        i, j = np.unravel_index(np.argmax(pair), pair.shape)
        chosen = [int(i), int(j)]
        best = pair[i, j]
        in_set = np.zeros(inum, bool)
        in_set[[i, j]] = True
        for _ in range(2, min(self.tau, inum)):
            gains = pair[:, chosen].sum(axis=1)
            gains[in_set] = -np.inf
            k = int(np.argmax(gains))
            in_set[k] = True
            chosen.append(k)
            best += gains[k]
        return float(best), [int(images[c]) for c in chosen]

    CHUNK = 8192   # points per batched-score2 chunk (bounds [B, V, V])

    # ---- pair-matrix cache ----
    # The angleScore x footprint pair matrix of a point depends only on
    # its coords and visible list; every greedy pass (thresholds,
    # removal, cluster assignment, coverage repair) only changes the
    # VALIDITY mask. Caching the raw matrices turns each pass into
    # masked argmax loops (the transcendental angleScore was >75% of
    # clustering time before this).
    # cache budget: above this the [P, V, V] pair tensor is not stored
    # and _pair_rows recomputes chunks on demand (dense-visibility
    # bundles would otherwise allocate tens of GB)
    PAIR_CACHE_BYTES = 1_500_000_000

    def _ensure_cache(self):
        if getattr(self, "_cache_ok", False):
            return
        self._vis_pad = pad_lists(self.visibles)
        p, v = self._vis_pad.shape
        if p * v * v * 4 > self.PAIR_CACHE_BYTES:
            self._pair = None
        else:
            img = np.maximum(self._vis_pad, 0)
            self._pair = np.empty((p, v, v), np.float32)
            for s in range(0, p, self.CHUNK):
                sl = slice(s, min(s + self.CHUNK, p))
                self._pair[sl] = pair_scores_batch(
                    self.prob.centers, self.prob.ipscales, self.coords[sl],
                    img[sl], None, masked=False)
        self._cache_ok = True

    def _pair_rows(self, rows) -> np.ndarray:
        """Pair matrices for `rows` (index array or slice): from the
        cache when it fits, recomputed on the fly otherwise."""
        self._ensure_cache()
        if self._pair is not None:
            return self._pair[rows]
        img = np.maximum(self._vis_pad[rows], 0)
        return pair_scores_batch(self.prob.centers, self.prob.ipscales,
                                 self.coords[rows], img, None,
                                 masked=False)

    def _invalidate_cache(self):
        self._cache_ok = False

    @property
    def vis_pad(self) -> np.ndarray:
        self._ensure_cache()
        return self._vis_pad

    def _score2_rows(self, rows, valid=None):
        """Batched computeScore2 over point rows (cached pair
        matrices, chunked)."""
        self._ensure_cache()
        if valid is None:
            valid = self._vis_pad[rows] >= 0
        scores = np.empty(len(rows))
        chosen = np.empty((len(rows), max(self.tau, 2)), dtype=np.int64)
        for s in range(0, len(rows), self.CHUNK):
            sl = slice(s, min(s + self.CHUNK, len(rows)))
            sc, ch = score2_from_pair(self._pair_rows(rows[sl]), valid[sl],
                                      self.tau)
            scores[sl] = sc
            chosen[sl] = ch
        return scores, chosen

    def set_score_thresholds(self):
        """scoreThreshold = full-visibility score x lambda
        (bundle.cpp:227-232). Batched over all points."""
        p = len(self.coords)
        vis_pad = self.vis_pad
        rows = np.arange(p)
        scores, chosen = self._score2_rows(rows)
        self.score_thresholds = scores * self.score_ratio
        self.uimages = [
            [int(vis_pad[i, c]) for c in chosen[i] if c >= 0]
            for i in range(p)]
        self.satisfied = np.ones(p, dtype=np.int8)

    # ---- vpoints / neighbors (bundle.cpp:410-432) ----
    def set_vpoints(self):
        self.vpoints: list[list[int]] = [[] for _ in range(self.prob.cnum)]
        for pid, vis in enumerate(self.visibles):
            for c in vis:
                self.vpoints[c].append(pid)

    def set_neighbors(self):
        cnum = self.prob.cnum
        neighbors = [set() for _ in range(cnum)]
        for vis in self.visibles:
            for a in vis:
                neighbors[a].update(vis)
        self.neighbors = [sorted(s - {c}) for c, s in enumerate(neighbors)]

    def _link_matrix(self) -> np.ndarray:
        """All pairwise link weights at once (bundle.cpp:173-190):
        link(i, j) = sum over shared points of
        pweight * pairScore(i, j) / (threshold / ratio). One scatter-add
        of every point's [V, V] pair matrix."""
        cnum = self.prob.cnum
        vis_pad = self.vis_pad
        p, v = vis_pad.shape
        self._ensure_cache()
        L = np.zeros(cnum * cnum)
        thr = self.score_thresholds / self.score_ratio
        w = np.where(thr != 0.0, self.pweights
                     / np.where(thr == 0.0, 1.0, thr), 0.0)
        eye = np.eye(vis_pad.shape[1], dtype=bool)[None]
        for s in range(0, p, self.CHUNK):
            sl = slice(s, min(s + self.CHUNK, p))
            imgs = vis_pad[sl]
            valid = imgs >= 0
            img = np.maximum(imgs, 0)
            ok = valid[:, :, None] & valid[:, None, :] & ~eye
            vals = np.where(ok, self._pair_rows(sl), 0.0) \
                * w[sl][:, None, None]
            idx = img[:, :, None] * cnum + img[:, None, :]
            L += np.bincount(idx.reshape(-1), weights=vals.reshape(-1),
                             minlength=cnum * cnum)
        return L.reshape(cnum, cnum)

    def slim_neighbors_set_links(self, maxneighbor: int = 30):
        """Cap neighbor lists at the 30 strongest links
        (bundle.cpp:192-225). Uses the batched link matrix."""
        L = self._link_matrix()
        self.links: list[list[float]] = []
        for c in range(self.prob.cnum):
            ls = [L[c, n] for n in self.neighbors[c]]
            if len(self.neighbors[c]) >= 2:
                order = sorted(range(len(ls)),
                               key=lambda k: (-ls[k], self.neighbors[c][k]))
                order = order[:maxneighbor]
                self.neighbors[c] = [self.neighbors[c][k] for k in order]
                ls = [ls[k] for k in order]
            self.links.append(ls)

    # ---- point compression (bundle.cpp:638-889) ----
    def _neighbor_candidates(self, min_scales) -> list[list[int]]:
        """Per-point merge candidates within min(r_i, r_j) (reference
        findPNeighbors, bundle.cpp:638-667). Uses the native Morton-order
        scan when built, scipy cKDTree otherwise."""
        p = len(self.coords)
        adj: list[list[int]] = [[] for _ in range(p)]
        try:
            from .. import _native
            flat = _native.radius_pairs(
                np.ascontiguousarray(self.coords, np.float32),
                np.ascontiguousarray(min_scales, np.float32))
            for k in range(0, len(flat), 2):
                i, j = flat[k], flat[k + 1]
                d = np.linalg.norm(self.coords[i] - self.coords[j])
                if d <= min_scales[i] and d <= min_scales[j]:
                    adj[i].append(j)
                    adj[j].append(i)
            return adj
        except ImportError:
            pass
        from scipy.spatial import cKDTree
        tree = cKDTree(self.coords)
        for pid in range(p):
            for pid2 in tree.query_ball_point(self.coords[pid],
                                              min_scales[pid]):
                if pid2 != pid:
                    d = np.linalg.norm(self.coords[pid2]
                                       - self.coords[pid])
                    if d <= min_scales[pid2]:
                        adj[pid].append(pid2)
        return adj

    def merge_sfm_points(self):
        p = len(self.coords)
        vis_pad = pad_lists(self.visibles)
        img = np.maximum(vis_pad, 0)
        dist = np.linalg.norm(self.coords[:, None, :]
                              - self.prob.centers[img], axis=-1)
        scale = dist * (1 << self.prob.dlevel) / self.prob.ipscales[img]
        min_scales = np.where(vis_pad >= 0, scale, np.inf).min(axis=1)

        adj = self._neighbor_candidates(min_scales)
        uf = UnionFind(p)
        merged = np.zeros(p, bool)
        order = np.random.default_rng(42).permutation(p)
        nsets = [set(n) for n in self.neighbors]
        for pid in order:
            if merged[pid]:
                continue
            vis = set(self.visibles[pid])
            for im in self.visibles[pid]:
                vis.update(nsets[im])
            merged[pid] = True
            for pid2 in adj[pid]:
                if merged[pid2]:
                    continue
                if vis & set(self.visibles[pid2]):
                    merged[pid2] = True
                    uf.union(pid, pid2)

        # compress components with >= 2 members (bundle.cpp:834-868)
        roots = np.array([uf.find(i) for i in range(p)])
        counts = np.bincount(roots, minlength=p)
        keep_roots = np.nonzero(counts >= 2)[0]
        root_map = {int(r): i for i, r in enumerate(keep_roots)}
        newp = len(keep_roots)
        newcoords = np.zeros((newp, 3))
        newweights = np.zeros(newp)
        newvis: list[set] = [set() for _ in range(newp)]
        for pid in range(p):
            r = roots[pid]
            if counts[r] < 2:
                continue
            k = root_map[int(r)]
            newcoords[k] += self.coords[pid]
            newweights[k] += 1
            newvis[k].update(self.visibles[pid])
        self.coords = newcoords / newweights[:, None]
        self.visibles = [sorted(v) for v in newvis]
        self.pweights = newweights
        self._invalidate_cache()
        self.log(f"mergeSfMP: {p} -> {newp} points")

    # ---- greedy image removal (bundle.cpp:234-408) ----
    def remove_images(self):
        cnum = self.prob.cnum
        self.set_vpoints()
        allows = np.array([
            math.ceil(len(self.vpoints[c]) * (1.0 - self.coverage))
            for c in range(cnum)])
        order = sorted(range(cnum), key=lambda c: (
            self.prob.widths[c] * self.prob.heights[c], c))
        vis_pad = self.vis_pad
        for image in order:
            self._check_image(image, allows, vis_pad)
        kept = int((~self.removed).sum())
        self.log(f"sRemoveImages: {cnum} -> {kept}")

    def _check_image(self, image: int, allows: np.ndarray,
                     vis_pad: np.ndarray):
        """One greedy removal trial (bundle.cpp:234-408). The per-point
        rescores run as one batched score2 over the image's points."""
        pids = np.asarray(self.vpoints[image], dtype=np.int64)
        if len(pids) == 0:
            self.removed[image] = True
            return
        sat = self.satisfied[pids] != 0
        # points whose optimal subset is intact and excludes `image`
        # keep status 1 without a rescore (bundle.cpp:316-326)
        need = np.zeros(len(pids), bool)
        for k, pid in enumerate(pids):
            if not sat[k]:
                continue
            u = self.uimages[pid]
            valid = all(not self.removed[i] for i in u)
            need[k] = (not valid) or (image in u)
        stats = np.where(sat, 1, 0)

        rows = pids[need]
        if len(rows):
            imgs = vis_pad[rows]
            valid = (imgs >= 0) & ~self.removed[np.maximum(imgs, 0)] \
                & (imgs != image)
            sc, _ = self._score2_rows(rows, valid=valid)
            fails = sc < self.score_thresholds[rows]
            stats[need] = np.where(fails, 2, 1)

        fail_pids = pids[stats == 2]
        decrements = np.zeros(self.prob.cnum, dtype=np.int64)
        if len(fail_pids):
            fimgs = vis_pad[fail_pids]
            fok = fimgs >= 0
            decrements = np.bincount(
                fimgs[fok].reshape(-1), minlength=self.prob.cnum)
        if np.any(allows < decrements):
            return
        self.removed[image] = True
        allows -= decrements
        self.satisfied[fail_pids] = 0
        # rescore points whose optimal subset contained the image
        redo = [pid for pid, st in zip(pids, stats)
                if st == 1 and image in self.uimages[pid]]
        if redo:
            rows = np.asarray(redo, dtype=np.int64)
            imgs = vis_pad[rows]
            valid = (imgs >= 0) & ~self.removed[np.maximum(imgs, 0)]
            sc, ch = self._score2_rows(rows, valid=valid)
            for k, pid in enumerate(rows):
                self.uimages[pid] = [int(vis_pad[pid, c])
                                     for c in ch[k] if c >= 0]
            self.satisfied[rows[sc < self.score_thresholds[rows]]] = 0

    def reset_visibles(self):
        self.visibles = [
            [i for i in vis if not self.removed[i]]
            for vis in self.visibles]
        self._invalidate_cache()

    # ---- partitioning (bundle.cpp:434-539; Graclus -> spectral) ----
    def divide_images(self, images: list[int]) -> list[list[int]]:
        iratio = 125.0 / 150.0
        out: list[list[int]] = []
        queue = [list(images)]
        while queue:
            cand = queue.pop(0)
            if len(cand) <= self.maximage * iratio:
                out.append(cand)
                continue
            g1, g2 = self._bisect(cand)
            for g in (g1, g2):
                if len(g) <= self.maximage * iratio:
                    out.append(g)
                else:
                    queue.append(g)
        return out

    def _bisect(self, cand: list[int]) -> tuple[list[int], list[int]]:
        """Spectral bisection with the same edge weights the reference
        feeds Graclus: min(5000, round(10 * link)) (bundle.cpp:494-505)."""
        n = len(cand)
        pos = {c: i for i, c in enumerate(cand)}
        W = np.zeros((n, n))
        for i, c in enumerate(cand):
            for nb, link in zip(self.neighbors[c], self.links[c]):
                j = pos.get(nb)
                if j is not None and j != i:
                    W[i, j] = min(5000.0, math.floor(10.0 * link + 0.5))
        W = np.maximum(W, W.T)
        d = W.sum(axis=1)
        d = np.where(d == 0.0, 1.0, d)
        dm = 1.0 / np.sqrt(d)
        L = np.eye(n) - dm[:, None] * W * dm[None, :]
        vals, vecs = np.linalg.eigh(L)
        fiedler = vecs[:, 1] * dm
        med = np.median(fiedler)
        side = fiedler > med
        # break ties so neither side is empty
        if side.all() or (~side).all():
            side = np.zeros(n, bool)
            side[np.argsort(fiedler)[n // 2:]] = True
        g1 = [cand[i] for i in range(n) if not side[i]]
        g2 = [cand[i] for i in range(n) if side[i]]
        return g1, g2

    # ---- cluster growth (bundle.cpp:973-1164) ----
    def _member_matrix(self) -> np.ndarray:
        """[cnum, n_clusters] cluster membership."""
        member = np.zeros((self.prob.cnum, len(self.timages)), bool)
        for c, t in enumerate(self.timages):
            member[t, c] = True
        return member

    def _set_clusters(self, rows: np.ndarray, vis_pad: np.ndarray,
                      member: np.ndarray):
        """Assign each point to its best-scoring cluster
        (bundle.cpp:889-953 setCluster), batched over points: one
        score2 per cluster over the visible-set intersections."""
        if len(rows) == 0:
            return
        imgs = vis_pad[rows]
        vok = imgs >= 0
        img = np.maximum(imgs, 0)
        nb = len(rows)
        best_score = np.full(nb, -1.0)
        best_cluster = np.full(nb, -1, dtype=np.int64)
        self._ensure_cache()
        for s in range(0, nb, self.CHUNK):
            sl = slice(s, min(s + self.CHUNK, nb))
            pair = self._pair_rows(rows[sl])
            # output-sensitive: a cluster scores -1 unless it contains
            # >= 2 of the point's visible images (score2's nvalid >= 2
            # gate), so only overlapping (point, cluster) pairs are
            # scored - the reference loops all clusters per point
            # (bundle.cpp:917-938) but the skipped ones cannot win
            mem_s = member[img[sl]] & vok[sl][..., None]  # [B, V, C]
            overlap = mem_s.sum(axis=1)                   # [B, C]
            pos = np.arange(sl.start, sl.stop)
            # ascending c keeps the reference's first-cluster tie-break
            for c in np.nonzero((overlap >= 2).any(axis=0))[0]:
                sub = np.nonzero(overlap[:, c] >= 2)[0]
                sc, _ = score2_from_pair(pair[sub], mem_s[sub, :, c],
                                         self.tau)
                at = pos[sub]
                better = sc > best_score[at]
                best_score[at] = np.where(better, sc, best_score[at])
                best_cluster[at] = np.where(better, c, best_cluster[at])
        # fallback: first visible image's first containing cluster
        # (bundle.cpp:939-951)
        miss = best_cluster == -1
        for v in range(imgs.shape[1]):
            if not miss.any():
                break
            has = member[img[:, v]]                       # [nb, C]
            found = miss & vok[:, v] & has.any(axis=1)
            best_cluster = np.where(found, has.argmax(axis=1),
                                    best_cluster)
            best_score = np.where(found, 0.0, best_score)
            miss = best_cluster == -1
        self.cluster[rows] = best_cluster
        self.cscore[rows] = best_score
        sat = best_score >= self.score_thresholds[rows]
        self.satisfied[rows[sat]] = 1
        if sat.any():
            simgs = imgs[sat]
            self.lacks -= np.bincount(simgs[simgs >= 0].reshape(-1),
                                      minlength=self.prob.cnum)

    def add_images_p(self):
        cnum = self.prob.cnum
        self.set_vpoints()
        self.lacks = np.array([
            0 if self.removed[c]
            else math.floor(len(self.vpoints[c]) * self.coverage)
            for c in range(cnum)], dtype=np.int64)

        p = len(self.coords)
        self.cluster = np.full(p, -1, dtype=np.int64)
        self.cscore = np.full(p, -1.0)
        vis_pad = self.vis_pad
        # setScoresClusters (bundle.cpp:889-899)
        rows = np.nonzero(self.satisfied != 0)[0]
        self.satisfied[rows] = 2
        self._set_clusters(rows, vis_pad, self._member_matrix())

        for _ in range(200):   # safety cap; reference loops unboundedly
            total = self._add_images(vis_pad)
            if total == 0:
                break
            if any(len(t) > self.maximage for t in self.timages):
                break
            rows = np.nonzero(self.satisfied == 2)[0]
            self._set_clusters(rows, vis_pad, self._member_matrix())

    def _add_images(self, vis_pad: np.ndarray) -> int:
        """One greedy round of coverage repair (bundle.cpp:1043-1164):
        candidate-image gains batched as one score2 per visible slot."""
        member = self._member_matrix()
        imgs_all = np.maximum(vis_pad, 0)
        lackhit = ((vis_pad >= 0)
                   & (self.lacks[imgs_all] > 0)).any(axis=1)
        flags = (self.satisfied == 2) & lackhit & (self.cluster >= 0)
        rows = np.nonzero(flags)[0]

        cands: list[dict] = [dict() for _ in self.timages]
        nb = len(rows)
        for s in range(0, nb, self.CHUNK):
            sl = rows[s:s + self.CHUNK]
            imgs = vis_pad[sl]
            vok = imgs >= 0
            img = np.maximum(imgs, 0)
            cl = self.cluster[sl]
            inmask = vok & member[img, cl[:, None]]       # current set
            base = self.cscore[sl]
            thr = self.score_thresholds[sl]
            pair = self._pair_rows(sl)
            for v in range(imgs.shape[1]):
                cand_ok = vok[:, v] & ~inmask[:, v]
                if not cand_ok.any():
                    continue
                sub = np.nonzero(cand_ok)[0]
                valid = inmask[sub].copy()
                valid[:, v] = True
                sc, _ = score2_from_pair(pair[sub], valid, self.tau)
                gain = (sc - base[sub]) / thr[sub]
                for k, g in zip(sub, gain):
                    if g <= 0.0:
                        continue
                    image = int(img[k, v])
                    cc = int(cl[k])
                    cands[cc][image] = cands[cc].get(image, 0.0) + g

        cands2 = [(-g, c, im) for c, m in enumerate(cands)
                  for im, g in m.items()]
        if not cands2:
            return 0
        cands2.sort()
        gain_threshold = -cands2[0][0] * 0.9
        blocked = np.zeros(self.prob.cnum, bool)
        added = 0
        for negg, cl, image in cands2:
            if -negg < gain_threshold:
                break
            if blocked[image]:
                continue
            added += 1
            blocked[image] = True
            for nb in self.neighbors[image]:
                blocked[nb] = True
            self.timages[cl].append(image)
        for t in self.timages:
            t.sort()
        return added

    # ---- full pipeline ----
    def run(self):
        self.set_vpoints()
        self.set_neighbors()
        self.set_score_thresholds()
        self.slim_neighbors_set_links()
        self.merge_sfm_points()
        self.set_vpoints()
        self.set_score_thresholds()
        self.remove_images()
        self.reset_visibles()
        self.set_vpoints()
        self.set_neighbors()
        self.slim_neighbors_set_links()

        # initial mutually exclusive clusters (bundle.cpp:434-455)
        lhs = [c for c in range(self.prob.cnum) if not self.removed[c]]
        if len(lhs) <= self.maximage:
            self.timages = [lhs]
        else:
            self.timages = self.divide_images(lhs)
        self.log("cluster sizes: "
                 + " ".join(str(len(t)) for t in self.timages))

        for _ in range(50):    # safety cap; reference loops unboundedly
            self.add_images_p()
            change = False
            newt: list[list[int]] = []
            for t in self.timages:
                if len(t) <= self.maximage:
                    newt.append(t)
                else:
                    change = True
                    newt.extend(self.divide_images(t))
            self.timages = newt
            if not change:
                break
        self.oimages = [[] for _ in self.timages]
        self.log("final clusters: "
                 + " ".join(str(len(t)) for t in self.timages))

    def write(self, prefix: str):
        write_vis(os.path.join(prefix, "vis.dat"), [
            [] if self.removed[c] else self.neighbors[c]
            for c in range(self.prob.cnum)])
        write_ske(os.path.join(prefix, "ske.dat"), self.prob.cnum,
                  self.timages, self.oimages)
        from ..io.ply import write_patch_ply
        for i, t in enumerate(self.timages):
            pts = self.prob.centers[t]
            with open(os.path.join(prefix, "centers-%04d.ply" % i),
                      "w") as f:
                f.write("ply\nformat ascii 1.0\n"
                        f"element vertex {len(pts)}\n"
                        "property float x\nproperty float y\n"
                        "property float z\nend_header\n")
                for c in pts:
                    f.write(f"{c[0]} {c[1]} {c[2]}\n")


def load_problem(prefix: str) -> CmvsProblem:
    """Read bundle.rd.out + txt cameras + image dims
    (reference CBundle::prep, bundle.cpp:35-72)."""
    bundle = read_bundle(os.path.join(prefix, "bundle.rd.out"))
    cnum = bundle.num_cameras
    centers = np.zeros((cnum, 3))
    ipscales = np.zeros(cnum)
    widths = np.zeros(cnum, dtype=np.int64)
    heights = np.zeros(cnum, dtype=np.int64)
    from ..io.images import find_image_path, image_size
    for c in range(cnum):
        P = read_camera_txt(os.path.join(prefix, "txt", "%08d.txt" % c))
        centers[c] = np.linalg.solve(P[:, :3], -P[:, 3])
        ipscales[c] = (np.linalg.norm(P[0, :3])
                       + np.linalg.norm(P[1, :3])) / 2.0
        path = find_image_path(os.path.join(prefix, "visualize"), c)
        if path is None:
            raise FileNotFoundError(f"missing image {c}")
        widths[c], heights[c] = image_size(path)
    # The reference hardcodes dlevel=7 assuming ~2Mpix SfM images
    # (bundle.cpp:65-66, "SfM was done on 2M pixels": 128px blocks on a
    # ~1600px-wide image). Scale the block size with actual resolution so
    # small scenes don't merge everything into one point.
    mean_w = float(widths.mean()) if cnum else 1600.0
    dlevel = int(np.clip(round(math.log2(max(mean_w / 16.0, 1.0))), 0, 12))
    return CmvsProblem(coords=bundle.coords, visibles=bundle.visibles,
                       centers=centers, ipscales=ipscales, widths=widths,
                       heights=heights, dlevel=dlevel)


def run_cmvs(prefix: str, maximage: int = 100, tau: int = 4,
             score_ratio: float = 0.7, coverage: float = 0.7,
             log=print) -> CmvsClustering:
    """cmvs3-equivalent entry (reference source/cmvs.cpp:7-59)."""
    prob = load_problem(prefix)
    c = CmvsClustering(prob, maximage, tau, score_ratio, coverage, log=log)
    c.run()
    c.write(prefix)
    return c
