"""Full-parity DpSeamFinder: component labeling, conflict resolution, seam
tips, horizontal AND vertical seams, and seam-guided relabeling.

Reconstruction of the reference's complete DpSeamFinder machinery
(ref 动态规划法寻找最佳缝合线.cpp):

  - ``process``           :127-193   union canvas + contour masks
  - ``findComponents``    :196-310   flood-fill FIRST/SECOND/INTERS labels
  - ``findEdges``         :311-393   weighted component adjacency
  - ``resolveConflicts``  :395-548   INTERS-vs-other conflict loop
  - ``getSeamTips``       :607-705   two farthest special-point clusters
  - ``computeCosts``      :733-803   costV/costH (COLOR / COLOR_GRAD)
  - ``estimateSeam``      :806-959   control/reachable DP between two tips,
                                     horizontal or vertical
  - ``updateLabelsUsingSeam`` :960-1093  flood-fill relabel across the seam

This is irregular, data-dependent host logic over a handful of components,
so it runs in NumPy (vectorized rasters) + the port's native CCL runtime
(imagestitch_tpu_torch.native.ccl: union-find labeling in C++), exactly as
`imagestitch_tpu.seam.dp_full` does, while the per-pixel cost maps are
whole-array expressions. The pipeline's host-seam split uses it for
``SeamConfig(full_components=True)``; the on-device windowed scan DP
(seam.dp) stays the default.
"""

from __future__ import annotations

import numpy as np

from imagestitch_tpu_torch.native.ccl import connected_components

# ComponentState bits (ref :73-79)
FIRST = 1
SECOND = 2
INTERS = 4

# badRegionCost = normL2(Point3f(255,255,255), 0) (:754-755) — OpenCV's
# stitching util normL2 is the SQUARED norm (util_inl.hpp), i.e. 3*255^2
_BAD = float(3 * 255.0 * 255.0)


def _contour_mask(mask: np.ndarray) -> np.ndarray:
    """Pixels of `mask` with a missing 4-neighbor or on the canvas border
    (ref :169-186)."""
    m = mask.astype(bool)
    up = np.ones_like(m)
    up[1:] = m[:-1]
    dn = np.ones_like(m)
    dn[:-1] = m[1:]
    lf = np.ones_like(m)
    lf[:, 1:] = m[:, :-1]
    rt = np.ones_like(m)
    rt[:, :-1] = m[:, 1:]
    # border pixels count as contour: shift-in "True" above makes an edge
    # neighbor look present, so handle borders explicitly
    border = np.zeros_like(m)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    inner_missing = ~(up & dn & lf & rt)
    return m & (inner_missing | border)


def _label_contour(labels: np.ndarray, l: int) -> np.ndarray:
    """Contour of the labels==l region (different-label or border neighbor,
    ref :246-253)."""
    eq = labels == l
    up = np.zeros_like(eq)
    up[1:] = eq[:-1]
    dn = np.zeros_like(eq)
    dn[:-1] = eq[1:]
    lf = np.zeros_like(eq)
    lf[:, 1:] = eq[:, :-1]
    rt = np.zeros_like(eq)
    rt[:, :-1] = eq[:, 1:]
    border = np.zeros_like(eq)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    return eq & (~(up & dn & lf & rt) | border)


class DpSeamFinder:
    """Reference-faithful DP seam finder over shared-frame image pairs.

    cost_func: "color" (diffL2Square3, ref :713-720) or "color_grad"
    (the same divided by Σ|Sobel|+1, ref :783-800).
    """

    def __init__(self, cost_func: str = "color"):
        assert cost_func in ("color", "color_grad")
        self.cost_func = cost_func

    # -- public API (ref find :87-124) -----------------------------------
    def find(self, images, corners, masks):
        """images: list of (Hi, Wi, 3) float arrays; corners: list of (x, y)
        ints; masks: list of (Hi, Wi) bool. Returns new masks (list).
        Pairs are processed in reversed i<j order like the reference
        (:98-111, std::reverse)."""
        n = len(images)
        masks = [np.asarray(m, bool).copy() for m in masks]
        pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
        for i0, i1 in reversed(pairs):
            m0, m1 = self.process(
                np.asarray(images[i0], np.float32),
                np.asarray(images[i1], np.float32),
                tuple(corners[i0]), tuple(corners[i1]),
                masks[i0], masks[i1])
            masks[i0], masks[i1] = m0, m1
        return masks

    # -- per-pair driver (ref process :127-193) ---------------------------
    def process(self, image1, image2, tl1, tl2, mask1, mask2):
        h1, w1 = mask1.shape
        h2, w2 = mask2.shape
        ix0 = max(tl1[0], tl2[0])
        iy0 = max(tl1[1], tl2[1])
        ix1 = min(tl1[0] + w1, tl2[0] + w2)
        iy1 = min(tl1[1] + h1, tl2[1] + h2)
        if ix0 >= ix1 or iy0 >= iy1:
            return mask1, mask2                       # no conflicts (:142)

        ux0 = min(tl1[0], tl2[0])
        uy0 = min(tl1[1], tl2[1])
        ux1 = max(tl1[0] + w1, tl2[0] + w2)
        uy1 = max(tl1[1] + h1, tl2[1] + h2)
        H, W = uy1 - uy0, ux1 - ux0
        self.union_tl = (ux0, uy0)

        m1 = np.zeros((H, W), bool)
        m2 = np.zeros((H, W), bool)
        oy1, ox1 = tl1[1] - uy0, tl1[0] - ux0
        oy2, ox2 = tl2[1] - uy0, tl2[0] - ux0
        m1[oy1:oy1 + h1, ox1:ox1 + w1] = mask1
        m2[oy2:oy2 + h2, ox2:ox2 + w2] = mask2
        self.mask1_, self.mask2_ = m1, m2
        self.contour1mask_ = _contour_mask(m1)
        self.contour2mask_ = _contour_mask(m2)
        # offsets: union coords + d = image coords (ref :523-524 inverted)
        self.dy1, self.dx1 = -oy1, -ox1
        self.dy2, self.dx2 = -oy2, -ox2
        self.image1, self.image2 = image1, image2

        self._find_components()
        self._find_edges()
        self._resolve_conflicts()

        # final mask update (ref :521-547)
        out1 = mask1.copy()
        out2 = mask2.copy()
        lab = self.labels_
        st = np.asarray([0] + self.states_, np.int32)   # state by label id
        lab2 = lab[oy2:oy2 + h2, ox2:ox2 + w2]
        # mask1 lookup at the same union pixel, 0 outside image1
        m1_at2 = m1[oy2:oy2 + h2, ox2:ox2 + w2]
        kill2 = (lab2 > 0) & ((st[lab2] & FIRST) > 0) & m1_at2
        out2[kill2] = False
        lab1 = lab[oy1:oy1 + h1, ox1:ox1 + w1]
        m2_at1 = m2[oy1:oy1 + h1, ox1:ox1 + w1]
        kill1 = (lab1 > 0) & ((st[lab1] & SECOND) > 0) & m2_at1
        out1[kill1] = False
        return out1, out2

    # -- findComponents (ref :196-310) ------------------------------------
    def _find_components(self):
        m1, m2 = self.mask1_, self.mask2_
        classes = [(m1 & m2, INTERS), (m1 & ~m2, FIRST), (m2 & ~m1, SECOND)]
        H, W = m1.shape
        labels = np.zeros((H, W), np.int32)
        comp_state, comp_first = [], []
        base = 0
        for cls_mask, state in classes:
            cl, n = connected_components(cls_mask)
            if n == 0:
                continue
            labels = np.where(cl > 0, cl + base, labels)
            # first-encounter raster index per component, for renumbering in
            # the reference's flood-fill scan order (:221-236)
            flat = cl.reshape(-1)
            idx = np.full(n + 1, flat.size, np.int64)
            nz = np.nonzero(flat)[0]
            np.minimum.at(idx, flat[nz], nz)
            comp_first.extend(idx[1:].tolist())
            comp_state.extend([state] * n)
            base += n
        order = np.argsort(np.asarray(comp_first), kind="stable")
        remap = np.zeros(base + 1, np.int32)
        remap[np.asarray(order) + 1] = np.arange(1, base + 1)
        self.labels_ = remap[labels]
        self.ncomps_ = base
        self.states_ = [comp_state[k] for k in order]
        # per-pair component lists: a finder reused for a later pair with
        # more components must not index the earlier pair's shorter lists
        self.tls_ = [None] * base
        self.brs_ = [None] * base
        self.contours_ = [None] * base
        self._refresh_component_info(range(base))

    def _refresh_component_info(self, comps, bbox=None):
        """(Re)compute tls_/brs_ (exclusive br) and contour point lists for
        the given component ids (ref :237-253, :481-511)."""
        lab = self.labels_
        for ci in comps:
            l = ci + 1
            if bbox is not None:
                x0, y0, x1, y1 = bbox
                sub = lab[y0:y1, x0:x1]
                ys, xs = np.nonzero(sub == l)
                ys = ys + y0
                xs = xs + x0
            else:
                ys, xs = np.nonzero(lab == l)
            if len(ys) == 0:
                self.tls_[ci] = (2 ** 30, 2 ** 30)
                self.brs_[ci] = (-2 ** 30, -2 ** 30)
                self.contours_[ci] = np.zeros((0, 2), np.int64)
                continue
            self.tls_[ci] = (int(xs.min()), int(ys.min()))
            self.brs_[ci] = (int(xs.max()) + 1, int(ys.max()) + 1)
            cont = _label_contour(lab, l)
            cys, cxs = np.nonzero(cont)
            self.contours_[ci] = np.stack([cxs, cys], axis=1)  # (N, 2) x,y

    # -- findEdges (ref :311-393) ------------------------------------------
    def _find_edges(self):
        lab = self.labels_
        pairs = set()
        for a, b in (
            (lab[:, 1:], lab[:, :-1]),
            (lab[1:, :], lab[:-1, :]),
        ):
            d = (a != b) & (a > 0) & (b > 0)
            if d.any():
                ij = np.stack([a[d], b[d]], axis=1)
                for ci, cj in np.unique(ij, axis=0):
                    pairs.add((int(ci) - 1, int(cj) - 1))
                    pairs.add((int(cj) - 1, int(ci) - 1))
        self.edges_ = pairs

    def _has_only_one_neighbor(self, comp) -> bool:
        return sum(1 for (a, _) in self.edges_ if a == comp) == 1

    # -- resolveConflicts (ref :395-548) -----------------------------------
    def _resolve_conflicts(self):
        if self.cost_func == "color_grad":
            self._compute_gradients()
        while True:
            conflict = None
            for c1, c2 in sorted(self.edges_):
                if (self.states_[c1] & INTERS) and \
                        (self.states_[c1] & ~INTERS) != self.states_[c2]:
                    conflict = (c1, c2)
                    break
            if conflict is None:
                break
            c1, c2 = conflict
            l1, l2 = c1 + 1, c2 + 1
            x0, y0 = self.tls_[c1]
            x1b, y1b = self.brs_[c1]
            if self._has_only_one_neighbor(c1):
                # absorb the whole INTERS component (:440-450)
                sub = self.labels_[y0:y1b, x0:x1b]
                sub[sub == l1] = l2
                self.states_[c1] = (SECOND if self.states_[c2] == FIRST
                                    else FIRST)
            else:
                tips = self._get_seam_tips(c1, c2)
                if tips is not None:
                    seam, horiz = self._estimate_seam(c1, *tips)
                    if seam is not None:
                        self._update_labels_using_seam(c1, c2, seam, horiz)
                self.states_[c1] = ((INTERS | SECOND)
                                    if self.states_[c2] == FIRST
                                    else (INTERS | FIRST))
            # refresh both components within the OLD c1/c2 bboxes (:481-511)
            ox0, oy0 = self.tls_[c2]
            ox1, oy1 = self.brs_[c2]
            self._refresh_component_info([c1], bbox=(x0, y0, x1b, y1b))
            bb2 = (min(x0, ox0), min(y0, oy0), max(x1b, ox1), max(y1b, oy1))
            self._refresh_component_info([c2], bbox=bb2)
            self.edges_.discard((c1, c2))
            self.edges_.discard((c2, c1))

    def _compute_gradients(self):
        """Sobel d/dx, d/dy of each gray image (ref computeGradients
        :549-573)."""
        def sobel_pair(img):
            g = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                 + 0.114 * img[..., 2]).astype(np.float32)
            gp = np.pad(g, 1, mode="reflect")   # cv2 BORDER_REFLECT_101
            gx = ((gp[:-2, 2:] + 2 * gp[1:-1, 2:] + gp[2:, 2:])
                  - (gp[:-2, :-2] + 2 * gp[1:-1, :-2] + gp[2:, :-2]))
            gy = ((gp[2:, :-2] + 2 * gp[2:, 1:-1] + gp[2:, 2:])
                  - (gp[:-2, :-2] + 2 * gp[:-2, 1:-1] + gp[:-2, 2:]))
            return gx, gy
        self.gradx1_, self.grady1_ = sobel_pair(self.image1)
        self.gradx2_, self.grady2_ = sobel_pair(self.image2)

    # -- getSeamTips (ref :607-705) -----------------------------------------
    def _get_seam_tips(self, comp1, comp2):
        lab = self.labels_
        H, W = lab.shape
        l2 = comp2 + 1
        pts = self.contours_[comp1]
        if len(pts) == 0:
            return None
        xs, ys = pts[:, 0], pts[:, 1]

        # closeToContour: any contour-mask pixel within radius 2 (:584-604)
        def close_to(cm):
            ok = np.zeros(len(pts), bool)
            for dy in range(-2, 3):
                yy = ys + dy
                v = (yy >= 0) & (yy < H)
                for dx in range(-2, 3):
                    xx = xs + dx
                    u = v & (xx >= 0) & (xx < W)
                    ok[u] |= cm[yy[u], xx[u]]
            return ok

        # 4-neighbor adjacency to comp2
        adj = np.zeros(len(pts), bool)
        for dy, dx in ((0, -1), (-1, 0), (0, 1), (1, 0)):
            yy, xx = ys + dy, xs + dx
            v = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            adj[v] |= lab[yy[v], xx[v]] == l2

        special = (close_to(self.contour1mask_) & close_to(self.contour2mask_)
                   & adj)
        sp = pts[special]
        if len(sp) < 2:
            return None

        # cluster by union-find over dist < 10 (cv::partition ClosePoints)
        n = len(sp)
        parent = np.arange(n)

        def root(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        d2 = ((sp[:, None, :] - sp[None, :, :]) ** 2).sum(-1)
        ii, jj = np.nonzero(d2 < 100)
        for a, b in zip(ii.tolist(), jj.tolist()):
            ra, rb = root(a), root(b)
            if ra != rb:
                parent[ra] = rb
        roots = np.asarray([root(i) for i in range(n)])
        uniq = np.unique(roots)
        if len(uniq) < 2:
            return None
        # centers (ref uses cvRound of integer-sum / size)
        centers, members = [], []
        for r in uniq:
            mem = sp[roots == r]
            members.append(mem)
            centers.append(np.round(mem.sum(0) / float(len(mem))))
        centers = np.asarray(centers, np.float64)
        # two most distant clusters
        best, bi, bj = -1.0, 0, 1
        for i in range(len(uniq) - 1):
            for j in range(i + 1, len(uniq)):
                dd = ((centers[i] - centers[j]) ** 2).sum()
                if dd > best:
                    best, bi, bj = dd, i, j
        out = []
        for k in (bi, bj):
            dd = ((members[k] - centers[k]) ** 2).sum(1)
            out.append(tuple(int(v) for v in members[k][int(np.argmin(dd))]))
        return out[0], out[1]

    # -- computeCosts (ref :733-803) ----------------------------------------
    def _compute_costs(self, comp):
        l = comp + 1
        x0, y0 = self.tls_[comp]
        x1, y1 = self.brs_[comp]
        lab = self.labels_
        H, W = lab.shape
        rh, rw = y1 - y0, x1 - x0
        dy1, dx1, dy2, dx2 = self.dy1, self.dx1, self.dy2, self.dx2
        im1, im2 = self.image1, self.image2

        def diff2(yA, xA, yB, xB):
            a = im1[yA, xA]
            b = im2[yB, xB]
            return ((a - b) ** 2).sum(-1).astype(np.float32)

        # vertical edge costs: seam between (x-1, x) neighbors (:757-777)
        yy, xx = np.mgrid[y0:y1, x0:x1 + 1]
        inb = xx < W
        xs = np.minimum(xx, W - 1)
        okv = (lab[yy, xs] == l) & (xx > 0) & inb
        xm = np.maximum(xx - 1, 0)
        okv &= lab[yy, xm] == l
        costV = np.full((rh, rw + 1), _BAD, np.float32)
        if okv.any():
            y_u, x_u = yy[okv], xx[okv]
            cc = 0.5 * (diff2(y_u + dy1, x_u + dx1 - 1, y_u + dy2, x_u + dx2)
                        + diff2(y_u + dy1, x_u + dx1,
                                y_u + dy2, x_u + dx2 - 1))
            if self.cost_func == "color_grad":
                cg = (np.abs(self.gradx1_[y_u + dy1, x_u + dx1])
                      + np.abs(self.gradx1_[y_u + dy1, x_u + dx1 - 1])
                      + np.abs(self.gradx2_[y_u + dy2, x_u + dx2])
                      + np.abs(self.gradx2_[y_u + dy2, x_u + dx2 - 1]) + 1.0)
                cc = cc / cg
            costV[y_u - y0, x_u - x0] = cc

        # horizontal edge costs: seam between (y-1, y) neighbors (:781-803)
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1]
        inb = yy < H
        ysc = np.minimum(yy, H - 1)
        okh = (lab[ysc, xx] == l) & (yy > 0) & inb
        ym = np.maximum(yy - 1, 0)
        okh &= lab[ym, xx] == l
        costH = np.full((rh + 1, rw), _BAD, np.float32)
        if okh.any():
            y_u, x_u = yy[okh], xx[okh]
            cc = 0.5 * (diff2(y_u + dy1 - 1, x_u + dx1, y_u + dy2, x_u + dx2)
                        + diff2(y_u + dy1, x_u + dx1,
                                y_u + dy2 - 1, x_u + dx2))
            if self.cost_func == "color_grad":
                cg = (np.abs(self.grady1_[y_u + dy1, x_u + dx1])
                      + np.abs(self.grady1_[y_u + dy1 - 1, x_u + dx1])
                      + np.abs(self.grady2_[y_u + dy2, x_u + dx2])
                      + np.abs(self.grady2_[y_u + dy2 - 1, x_u + dx2]) + 1.0)
                cc = cc / cg
            costH[y_u - y0, x_u - x0] = cc
        return costV, costH

    # -- estimateSeam (ref :806-959) -----------------------------------------
    def _estimate_seam(self, comp, p1, p2):
        """DP between tips p1, p2 (union coords, (x, y)). Returns
        (seam list of (x, y) from p1 to p2, is_horizontal) or (None, False).

        The reference's control/reachable double loop is row/column
        sequential with an O(extent) vectorized inner dimension here.
        """
        costV, costH = self._compute_costs(comp)
        x0, y0 = self.tls_[comp]
        x1, y1 = self.brs_[comp]
        lab = self.labels_
        l = comp + 1
        rh, rw = y1 - y0, x1 - x0
        src = np.asarray([p1[0] - x0, p1[1] - y0])      # (x, y) roi-local
        dst = np.asarray([p2[0] - x0, p2[1] - y0])

        horiz = abs(dst[0] - src[0]) > abs(dst[1] - src[1])
        swapped = False
        if horiz:
            if src[0] > dst[0]:
                src, dst = dst, src
                swapped = True
        elif src[1] > dst[1]:
            src, dst = dst, src
            swapped = True

        comp_mask = lab[y0:y1, x0:x1] == l
        control = np.zeros((rh, rw), np.uint8)
        reach = np.zeros((rh, rw), bool)
        cost = np.zeros((rh, rw), np.float32)
        reach[src[1], src[0]] = True

        if horiz:
            for x in range(src[0] + 1, dst[0] + 1):
                ok = comp_mask[:, x]
                cands = np.full((3, rh), np.inf, np.float32)
                r = reach[:, x - 1]
                cands[0] = np.where(r, cost[:, x - 1] + costH[:rh, x - 1],
                                    np.inf)
                ru = np.zeros(rh, bool)
                ru[1:] = reach[:-1, x - 1]
                cu = np.zeros(rh, np.float32)
                cu[1:] = cost[:-1, x - 1] + costH[:rh - 1, x - 1] \
                    + costV[:rh - 1, x]
                cands[1] = np.where(ru, cu, np.inf)
                rd = np.zeros(rh, bool)
                rd[:-1] = reach[1:, x - 1]
                cd = np.zeros(rh, np.float32)
                cd[:-1] = cost[1:, x - 1] + costH[1:rh, x - 1] + costV[:, x][:rh - 1]
                cands[2] = np.where(rd, cd, np.inf)
                cands[:, ~ok] = np.inf
                best = np.argmin(cands, axis=0)
                bc = cands[best, np.arange(rh)]
                new_reach = np.isfinite(bc)
                cost[:, x] = np.where(new_reach, bc, 0.0)
                control[:, x] = np.where(new_reach, best + 1, 0)
                reach[:, x] = new_reach
        else:
            for y in range(src[1] + 1, dst[1] + 1):
                ok = comp_mask[y]
                cands = np.full((3, rw), np.inf, np.float32)
                r = reach[y - 1]
                cands[0] = np.where(r, cost[y - 1] + costV[y - 1, :rw],
                                    np.inf)
                rl = np.zeros(rw, bool)
                rl[1:] = reach[y - 1, :-1]
                cl = np.zeros(rw, np.float32)
                cl[1:] = cost[y - 1, :-1] + costV[y - 1, :rw - 1] \
                    + costH[y, :rw - 1]
                cands[1] = np.where(rl, cl, np.inf)
                rr = np.zeros(rw, bool)
                rr[:-1] = reach[y - 1, 1:]
                cr = np.zeros(rw, np.float32)
                cr[:-1] = cost[y - 1, 1:] + costV[y - 1, 1:rw] + costH[y, :rw][:rw - 1]
                cands[2] = np.where(rr, cr, np.inf)
                cands[:, ~ok] = np.inf
                best = np.argmin(cands, axis=0)
                bc = cands[best, np.arange(rw)]
                new_reach = np.isfinite(bc)
                cost[y] = np.where(new_reach, bc, 0.0)
                control[y] = np.where(new_reach, best + 1, 0)
                reach[y] = new_reach

        if not reach[dst[1], dst[0]]:
            return None, horiz

        # backtrack (:923-947)
        seam = []
        p = dst.copy()
        seam.append((int(p[0] + x0), int(p[1] + y0)))
        if horiz:
            while p[0] != src[0]:
                c = control[p[1], p[0]]
                if c == 2:
                    p[1] -= 1
                elif c == 3:
                    p[1] += 1
                p[0] -= 1
                seam.append((int(p[0] + x0), int(p[1] + y0)))
        else:
            while p[1] != src[1]:
                c = control[p[1], p[0]]
                if c == 2:
                    p[0] -= 1
                elif c == 3:
                    p[0] += 1
                p[1] -= 1
                seam.append((int(p[0] + x0), int(p[1] + y0)))
        if not swapped:
            seam.reverse()
        return seam, horiz

    # -- updateLabelsUsingSeam (ref :960-1093) --------------------------------
    def _update_labels_using_seam(self, comp1, comp2, seam, horiz):
        x0, y0 = self.tls_[comp1]
        x1, y1 = self.brs_[comp1]
        lab = self.labels_
        H, W = lab.shape
        l1, l2 = comp1 + 1, comp2 + 1
        rh, rw = y1 - y0, x1 - x0
        mask = np.zeros((rh, rw), np.int32)
        cont = self.contours_[comp1]
        mask[cont[:, 1] - y0, cont[:, 0] - x0] = 255
        seam_a = np.asarray(seam, np.int64)
        mask[seam_a[:, 1] - y0, seam_a[:, 0] - x0] = 255

        # flood-fill sub-components of comp1 cut by the seam (:985-989)
        fillable = (mask == 0) & (lab[y0:y1, x0:x1] == l1)
        sub, ncomps = connected_components(fillable)
        # renumber in raster first-encounter order like repeated floodFill
        flat = sub.reshape(-1)
        first = np.full(ncomps + 1, flat.size, np.int64)
        nz = np.nonzero(flat)[0]
        if len(nz):
            np.minimum.at(first, flat[nz], nz)
        order = np.argsort(first[1:], kind="stable")
        remap = np.zeros(ncomps + 1, np.int32)
        remap[np.asarray(order) + 1] = np.arange(1, ncomps + 1)
        sub = remap[sub]
        mask = np.where(mask == 255, 255, sub)

        # attach contour points to adjacent sub-components (8-neigh,
        # sequential like the reference: later points may read earlier
        # assignments, :991-1007)
        dxs = (-1, +1, 0, 0, -1, +1, -1, +1)
        dys = (0, 0, -1, +1, -1, -1, +1, +1)
        for px, py in cont:
            x, y = px - x0, py - y0
            ok = False
            for j in range(8):
                c, r = x + dxs[j], y + dys[j]
                if 0 <= c < rw and 0 <= r < rh and mask[r, c] \
                        and mask[r, c] != 255:
                    ok = True
                    mask[y, x] = mask[r, c]
            if not ok:
                mask[y, x] = 0

        # attach seam points to the below/right side (:1009-1034)
        for sx, sy in seam:
            x, y = sx - x0, sy - y0
            if horiz:
                if y < rh - 1 and mask[y + 1, x] and mask[y + 1, x] != 255:
                    mask[y, x] = mask[y + 1, x]
                else:
                    mask[y, x] = 0
            else:
                if x < rw - 1 and mask[y, x + 1] and mask[y, x + 1] != 255:
                    mask[y, x] = mask[y, x + 1]
                else:
                    mask[y, x] = 0

        # which sub-components touch comp2 / other components (:1037-1086)
        connect2 = np.zeros(ncomps + 1, np.int64)
        connect_other = np.zeros(ncomps + 1, np.int64)
        for px, py in cont:
            t2 = other = False
            for dy, dx in ((0, -1), (-1, 0), (0, 1), (1, 0)):
                yy, xx = py + dy, px + dx
                if 0 <= yy < H and 0 <= xx < W:
                    lv = lab[yy, xx]
                    if lv == l2:
                        t2 = True
                    elif lv != l1 and lv != 0:
                        other = True
            mv = mask[py - y0, px - x0]
            if t2:
                connect2[mv if mv != 255 else 0] += 1
            if other:
                connect_other[mv if mv != 255 else 0] += 1

        ln = float(len(cont))
        is_adj = np.zeros(ncomps + 1, bool)
        for i in range(1, ncomps + 1):
            is_adj[i] = (connect2[i] / ln > 0.05
                         and connect_other[i] / ln < 0.1)

        # relabel adopted sub-components to comp2 (:1088-1092)
        take = (mask > 0) & (mask != 255) & is_adj[np.minimum(mask, ncomps)]
        subl = lab[y0:y1, x0:x1]
        subl[take] = l2


def dp_seam_find_full(images, corners, masks, use_grad: bool = False):
    """Functional wrapper: full-parity DP seam over shared-frame canvases.

    images: (N, H, W, 3) array or list; corners: (N, 2) (x, y); masks:
    (N, H, W) bool. Returns list of new masks.
    """
    finder = DpSeamFinder("color_grad" if use_grad else "color")
    return finder.find(list(images), list(corners), list(masks))
