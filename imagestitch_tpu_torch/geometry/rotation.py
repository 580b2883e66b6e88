"""Camera recovery (`imagestitch_tpu.geometry.rotation`): the shared focal
from the pairs' homographies, rotations chained R_to = R_from·K⁻¹·H⁻¹·K,
principal points at the image centres.

- `estimate_cameras`: the sequential chain i -> i+1;
- `estimate_cameras_spliced`: the chain with one broken link bridged by
  the skip pair i-1 -> i+1, and which images the chain reaches;
- `max_spanning_tree` and `estimate_cameras_host`: any pair topology, on
  the host in NumPy (Kruskal over the inlier counts, the largest
  component, rotations chained along the tree from its min-max-depth
  center);
- `affine_cameras` and `estimate_affine_host`: SCANS mode's cameras,
  global affine transforms (OpenCV's AffineBasedEstimator) chained along
  the same tree on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from imagestitch_tpu_torch.geometry.autocalib import estimate_focal
from imagestitch_tpu_torch.types import CameraParams


def _K_of(focal, aspect, ppx, ppy) -> np.ndarray:
    K = np.eye(3, dtype=np.float64)
    K[0, 0] = focal
    K[0, 2] = ppx
    K[1, 1] = focal * aspect
    K[1, 2] = ppy
    return K


def estimate_cameras(Hs_chain: torch.Tensor, pair_valid: torch.Tensor,
                     img_sizes: torch.Tensor) -> CameraParams:
    """Hs_chain: (N-1, 3, 3), Hs_chain[i] mapping image i's
    center-normalized points into image i+1's; img_sizes (N, 2) [h, w]."""
    dev = Hs_chain.device
    num_images = Hs_chain.shape[0] + 1
    focal = estimate_focal(Hs_chain, pair_valid, img_sizes, num_images)
    one = torch.ones((), dtype=torch.float32, device=dev)
    K = torch.diag(torch.stack([focal, focal, one]))
    Kinv = torch.diag(torch.stack([1.0 / focal, 1.0 / focal, one]))
    Rs = [torch.eye(3, dtype=torch.float32, device=dev)]
    for i in range(num_images - 1):
        Rs.append(Rs[-1] @ (Kinv @ torch.linalg.inv(Hs_chain[i]) @ K))
    sizes = img_sizes.to(device=dev, dtype=torch.float32)
    return CameraParams(
        focal=focal.expand(num_images).clone(),
        aspect=torch.ones(num_images, dtype=torch.float32, device=dev),
        ppx=0.5 * sizes[:, 1],
        ppy=0.5 * sizes[:, 0],
        R=torch.stack(Rs),
        t=torch.zeros((num_images, 3), dtype=torch.float32, device=dev),
    )


def _chain_mats(focal: torch.Tensor):
    one = torch.ones((), dtype=torch.float32, device=focal.device)
    K = torch.diag(torch.stack([focal, focal, one]))
    Kinv = torch.diag(torch.stack([1.0 / focal, 1.0 / focal, one]))
    return K, Kinv


def _cameras(focal: torch.Tensor, R: torch.Tensor,
             img_sizes: torch.Tensor) -> CameraParams:
    n = R.shape[0]
    dev = R.device
    sizes = img_sizes.to(device=dev, dtype=torch.float32)
    return CameraParams(
        focal=focal.to(device=dev, dtype=torch.float32).expand(n).clone(),
        aspect=torch.ones(n, dtype=torch.float32, device=dev),
        ppx=0.5 * sizes[:, 1],
        ppy=0.5 * sizes[:, 0],
        R=R.to(torch.float32),
        t=torch.zeros((n, 3), dtype=torch.float32, device=dev))


def estimate_cameras_spliced(H1: torch.Tensor, valid1: torch.Tensor,
                             good1: torch.Tensor, H2: torch.Tensor,
                             valid2: torch.Tensor, good2: torch.Tensor,
                             img_sizes: torch.Tensor):
    """Chain camera recovery with a one-gap splice. H1 (N-1, 3, 3): the
    consecutive i -> i+1 homographies; H2 (N-2, 3, 3): the skip pairs
    i -> i+2. `valid*` (h_valid) feed the focal median; `good*` (h_valid
    and confident) feed the chain: a broken link i -> i+1 is bridged by the
    skip pair i-1 -> i+1 when that pair is good and image i-1 was reached.
    Returns (CameraParams, reachable (N,) bool)."""
    dev = H1.device
    n1 = H1.shape[0]
    num_images = n1 + 1
    focal = estimate_focal(torch.cat([H1, H2]), torch.cat([valid1, valid2]),
                           img_sizes, num_images)
    K, Kinv = _chain_mats(focal)
    step1 = [Kinv @ torch.linalg.inv(H1[i]) @ K for i in range(n1)]
    step2 = [Kinv @ torch.linalg.inv(H2[i]) @ K for i in range(H2.shape[0])]
    Rs = [torch.eye(3, dtype=torch.float32, device=dev)]
    reach = [torch.ones((), dtype=torch.bool, device=dev)]
    for i in range(n1):
        cand1 = Rs[i] @ step1[i]
        ok1 = good1[i] & reach[i]
        if i >= 1:
            cand2 = Rs[i - 1] @ step2[i - 1]
            ok2 = good2[i - 1] & reach[i - 1]
            Rs.append(torch.where(ok1, cand1, torch.where(ok2, cand2, cand1)))
            reach.append(ok1 | ok2)
        else:
            Rs.append(cand1)
            reach.append(ok1)
    return _cameras(focal, torch.stack(Rs), img_sizes), torch.stack(reach)


def max_spanning_tree(num_images: int, pair_from: np.ndarray,
                      pair_to: np.ndarray, weights: np.ndarray):
    """Kruskal maximum spanning tree over the pairs' weights (inlier
    counts; pairs of weight <= 0 are left out), and its center: the node
    of the largest component with the least maximum BFS depth within it.

    Returns (edges, center, reachable): edges (from, to) in BFS order from
    the center outward; reachable (num_images,) bool marks the largest
    component (leaveBiggestComponent: the other images are not composed)."""
    order = np.argsort(-np.asarray(weights))
    parent = list(range(num_images))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    adj: list[list[int]] = [[] for _ in range(num_images)]
    for e in order:
        a, b = int(pair_from[e]), int(pair_to[e])
        if weights[e] <= 0:
            continue
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            adj[a].append(b)
            adj[b].append(a)

    roots = np.asarray([find(i) for i in range(num_images)])
    root_ids, counts = np.unique(roots, return_counts=True)
    reachable = roots == root_ids[np.argmax(counts)]

    def bfs_depths(start):
        depth = np.full(num_images, -1, np.int32)
        depth[start] = 0
        q = [start]
        while q:
            u = q.pop(0)
            for v in adj[u]:
                if depth[v] < 0:
                    depth[v] = depth[u] + 1
                    q.append(v)
        return depth

    best_center, best_max = int(np.nonzero(reachable)[0][0]), None
    for c in np.nonzero(reachable)[0]:
        mx = bfs_depths(int(c))[reachable].max()
        if best_max is None or mx < best_max:
            best_center, best_max = int(c), mx

    edges = []
    seen = {best_center}
    q = [best_center]
    while q:
        u = q.pop(0)
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                edges.append((u, v))
                q.append(v)
    return edges, best_center, reachable


def estimate_cameras_host(Hs: np.ndarray, pair_from: np.ndarray,
                          pair_to: np.ndarray, num_inliers: np.ndarray,
                          pair_valid: np.ndarray, img_sizes: np.ndarray,
                          return_tree: bool = False, device=None):
    """Camera recovery for any pair topology, on the host. Hs (P, 3, 3):
    H[p] maps pair_from[p]'s center-normalized points into pair_to[p]'s.
    Rotations chain along `max_spanning_tree` of the valid pairs, in
    float64; images outside its largest component keep R = I. Returns
    CameraParams on `device` (default: the CPU), and with `return_tree`
    also (edges, reachable) of the tree."""
    Hs = np.asarray(Hs, np.float64)
    pair_valid = np.asarray(pair_valid, bool)
    num_images = int(np.asarray(img_sizes).shape[0])
    focal = estimate_focal(torch.as_tensor(Hs, dtype=torch.float32),
                           torch.as_tensor(pair_valid),
                           torch.as_tensor(np.asarray(img_sizes)),
                           num_images)
    f = float(focal)

    valid_idx = np.nonzero(pair_valid)[0]
    edges, _, reachable = max_spanning_tree(
        num_images, np.asarray(pair_from)[valid_idx],
        np.asarray(pair_to)[valid_idx], np.asarray(num_inliers)[valid_idx])

    Hmap = {}
    for p in valid_idx:
        a, b = int(pair_from[p]), int(pair_to[p])
        Hmap[(a, b)] = Hs[p]
        Hmap[(b, a)] = np.linalg.inv(Hs[p])
    R = np.tile(np.eye(3, dtype=np.float64), (num_images, 1, 1))
    K = _K_of(f, 1.0, 0.0, 0.0)
    Kinv = np.linalg.inv(K)
    for u, v in edges:
        R[v] = R[u] @ (Kinv @ np.linalg.inv(Hmap[(u, v)]) @ K)

    dev = torch.device("cpu") if device is None else torch.device(device)
    cams = _cameras(focal.to(dev),
                    torch.as_tensor(R.astype(np.float32), device=dev),
                    torch.as_tensor(np.asarray(img_sizes, np.float64)
                                    .astype(np.float32), device=dev))
    if return_tree:
        return cams, edges, reachable
    return cams


def affine_cameras(Gs) -> CameraParams:
    """CameraParams carrying global affine transforms G_i (image-i pixels
    -> canvas): K = I (focal 1, principal point 0) and R = G_i. The plane
    projector's backward map K·R⁻¹·[u, v, 1] at scale 1 is then the affine
    warp G_i⁻¹·[u, v, 1], so the warp kernel serves SCANS mode as it is.
    On the device of `Gs` (a tensor), else on the CPU."""
    Gs = torch.as_tensor(Gs, dtype=torch.float32)
    n = Gs.shape[0]
    dev = Gs.device

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return CameraParams(focal=full(1.0), aspect=full(1.0), ppx=full(0.0),
                        ppy=full(0.0), R=Gs,
                        t=torch.zeros((n, 3), dtype=torch.float32,
                                      device=dev))


def estimate_affine_host(Hs: np.ndarray, pair_from: np.ndarray,
                         pair_to: np.ndarray, num_inliers: np.ndarray,
                         pair_valid: np.ndarray, num_images: int,
                         return_tree: bool = False, device=None):
    """Affine camera recovery for any pair topology, on the host (the
    SCANS family's AffineBasedEstimator). Hs (P, 3, 3): H[p] maps
    pair_from[p]'s raw pixel coordinates into pair_to[p]'s, last row
    (0, 0, 1). Global transforms chain G_v = G_u·H_uv⁻¹ in float64 along
    `max_spanning_tree` of the valid pairs from its center (G = I), whose
    frame is the canvas. Returns `affine_cameras` on `device` (default:
    the CPU), and with `return_tree` also (edges, reachable)."""
    Hs = np.asarray(Hs, np.float64)
    valid_idx = np.nonzero(np.asarray(pair_valid, bool))[0]
    edges, _, reachable = max_spanning_tree(
        num_images, np.asarray(pair_from)[valid_idx],
        np.asarray(pair_to)[valid_idx], np.asarray(num_inliers)[valid_idx])
    Gmap = {}
    for p in valid_idx:
        a, b = int(pair_from[p]), int(pair_to[p])
        Gmap[(a, b)] = Hs[p]
        Gmap[(b, a)] = np.linalg.inv(Hs[p])
    G = np.tile(np.eye(3, dtype=np.float64), (num_images, 1, 1))
    for u, v in edges:
        G[v] = G[u] @ np.linalg.inv(Gmap[(u, v)])
    dev = torch.device("cpu") if device is None else torch.device(device)
    cams = affine_cameras(torch.as_tensor(G.astype(np.float32), device=dev))
    if return_tree:
        return cams, edges, reachable
    return cams
