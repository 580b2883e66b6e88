"""Host image I/O, the real-photo fixtures and synthetic test scenes with
known geometry (host NumPy and PIL).

The same functions as `imagestitch_tpu.utils.io`: `imread` / `imwrite`;
`load_photo`, `photo_rotation_pair` and `photo_translation_pair` on the
vendored real photograph (this package's own copy in `utils/data/`,
CC-BY 2.0, see `data/ATTRIBUTION.txt`); the generators `synthetic_pair`,
`synthetic_rotation_pair`, `synthetic_affine_pair` and the N-view
`synthetic_sequence` and `synthetic_grid`. Kept as this package's own
copy so that it imports nothing of the JAX package; the same seeds give
the same pixels. `synthetic_pan_sequence` (a panning camera's views) is
this package's own.
"""

from __future__ import annotations

import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def imread(path: str) -> np.ndarray:
    """Read an image file to (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write (H, W[, 3]) uint8 (or float in [0, 255], clipped) to an image
    file; the format follows the file's extension."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_photo() -> np.ndarray:
    """The vendored real photograph, (427, 640, 3) uint8 RGB: a temple with
    real sensor noise, foliage texture and exposure falloff."""
    return imread(os.path.join(DATA_DIR, "china.jpg"))


def photo_rotation_pair(yaw_deg: float = 7.0, pitch_deg: float = 0.7,
                        roll_deg: float = 1.0):
    """Two rotating-camera 360x420 views of the real photograph, focal
    0.9 x width. Returns (img1, img2, H_true, focal)."""
    scene = load_photo().astype(np.float32)
    height, width = 360, 420
    return rotation_views_of_scene(scene, height, width, 0.9 * width,
                                   yaw_deg, pitch_deg, roll_deg)


def photo_translation_pair(overlap: float = 0.5):
    """Two overlapping crops of the real photograph at its native height
    (a sideways-tracking camera): the overlap pixels are the same sensor
    data in both. Returns (img1, img2, shift_px), img2 being img1 shifted
    left by shift_px."""
    scene = load_photo()
    height, width = scene.shape[:2]
    w = int(width / (2.0 - overlap))
    shift = width - w
    img1 = np.ascontiguousarray(scene[:, :w])
    img2 = np.ascontiguousarray(scene[:, shift:shift + w])
    return img1, img2, shift


def _render_scene(height: int, width: int, seed: int) -> np.ndarray:
    """Deterministic corner-rich texture: random rectangles + blobs + grid."""
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img[..., 0] = 90 + 50 * np.sin(xx / 97.0) * np.cos(yy / 71.0)
    img[..., 1] = 100 + 40 * np.cos(xx / 53.0 + 1.0)
    img[..., 2] = 110 + 45 * np.sin(yy / 83.0 + 2.0)
    for _ in range(160):
        h = int(rng.integers(8, height // 6))
        w = int(rng.integers(8, width // 6))
        y = int(rng.integers(0, height - h))
        x = int(rng.integers(0, width - w))
        color = rng.uniform(0, 255, size=3).astype(np.float32)
        img[y:y + h, x:x + w] = 0.25 * img[y:y + h, x:x + w] + 0.75 * color
    for _ in range(300):
        y = int(rng.integers(2, height - 2))
        x = int(rng.integers(2, width - 2))
        color = rng.uniform(0, 255, size=3).astype(np.float32)
        img[y - 1:y + 2, x - 1:x + 2] = color
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_pair(height: int = 480, width: int = 640, overlap: float = 0.4,
                   seed: int = 7, focal: float | None = None):
    """Two overlapping views of one scene related by a pure x-translation.

    Returns (img1, img2, true_shift_x): pixel (x, y) of img2 equals pixel
    (x + true_shift_x, y) of img1 inside the overlap."""
    shift = int(round(width * (1.0 - overlap)))
    scene = _render_scene(height, width + shift, seed)
    img1 = scene[:, :width]
    img2 = scene[:, shift:shift + width]
    return np.ascontiguousarray(img1), np.ascontiguousarray(img2), shift


def synthetic_sequence(n: int, height: int = 480, width: int = 640,
                       overlap: float = 0.5, seed: int = 7):
    """N overlapping views sliding across one wide scene (the multi-image
    panorama fixture). Returns (list of (H, W, 3) uint8, shift per step)."""
    shift = int(round(width * (1.0 - overlap)))
    scene = _render_scene(height, width + shift * (n - 1), seed)
    views = [np.ascontiguousarray(scene[:, i * shift:i * shift + width])
             for i in range(n)]
    return views, shift


def synthetic_pan_sequence(n: int, height: int = 160, width: int = 224,
                           step_deg: float = 10.0, seed: int = 7):
    """N views of one planar scene from a camera panning `step_deg` a view
    about its centre, focal 0.9 x width: the N-view counterpart of
    `synthetic_rotation_pair`, where the focal is well determined."""
    f = 0.9 * width
    half = np.deg2rad(step_deg * (n - 1) / 2)
    sh = height + height // 3
    sw = width + int(np.ceil(2 * f * np.tan(half) + 0.25 * width))
    scene = _render_scene(sh, sw, seed).astype(np.float32)
    K = np.array([[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2],
                  [0, 0, 1.0]])
    Ks = np.array([[f, 0, (sw - 1) / 2], [0, f, (sh - 1) / 2], [0, 0, 1.0]])
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    views = []
    for i in range(n):
        R = _rot_ypr(np.deg2rad(step_deg * (i - (n - 1) / 2)), 0.0, 0.0)
        M = Ks @ R.T @ np.linalg.inv(K)
        px = M[0, 0] * xs + M[0, 1] * ys + M[0, 2]
        py = M[1, 0] * xs + M[1, 1] * ys + M[1, 2]
        pz = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
        views.append(np.clip(_bilinear_sample(scene, px / pz, py / pz),
                             0, 255).astype(np.uint8))
    return views


def synthetic_affine_pair(height: int = 480, width: int = 640,
                          angle_deg: float = 6.0, scale: float = 1.05,
                          tx: float | None = None, ty: float = 10.0,
                          seed: int = 7):
    """Two views of one planar scene related by a similarity transform (a
    flatbed or drone scan: in-plane rotation, scale and translation, no
    perspective). Returns (img1, img2, A_true (2, 3) float64) with
    pixel_view2 = A_true · [pixel_view1, 1]."""
    if tx is None:
        tx = 0.45 * width
    th = np.deg2rad(angle_deg)
    # M maps view-2 pixels to scene pixels (the scene extends view 1)
    c, s = np.cos(th), np.sin(th)
    M = np.array([[scale * c, -scale * s, tx],
                  [scale * s, scale * c, ty],
                  [0.0, 0.0, 1.0]])
    corners = np.array([[0, 0, 1], [width, 0, 1], [0, height, 1],
                        [width, height, 1]], np.float64) @ M.T
    sw = int(np.ceil(max(width, corners[:, 0].max()))) + 2
    sh = int(np.ceil(max(height, corners[:, 1].max()))) + 2
    scene = _render_scene(sh, sw, seed).astype(np.float32)
    img1 = np.clip(scene[:height, :width], 0, 255).astype(np.uint8)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    px = M[0, 0] * xs + M[0, 1] * ys + M[0, 2]
    py = M[1, 0] * xs + M[1, 1] * ys + M[1, 2]
    img2 = np.clip(_bilinear_sample(scene, px, py), 0, 255).astype(np.uint8)
    return img1, img2, np.linalg.inv(M)[:2]


def synthetic_grid(rows: int, cols: int, height: int = 480, width: int = 640,
                   overlap: float = 0.5, seed: int = 7):
    """rows x cols overlapping viewports tiling one large scene in both
    directions (the 2-D panorama fixture: horizontal and vertical
    overlaps). Returns (views row-major, shift_x, shift_y)."""
    sx = int(round(width * (1.0 - overlap)))
    sy = int(round(height * (1.0 - overlap)))
    scene = _render_scene(height + sy * (rows - 1),
                          width + sx * (cols - 1), seed)
    views = [np.ascontiguousarray(
                scene[r * sy:r * sy + height, c * sx:c * sx + width])
             for r in range(rows) for c in range(cols)]
    return views, sx, sy


def _bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray):
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 2)
    fx = np.clip(x - x0, 0.0, 1.0)[..., None]
    fy = np.clip(y - y0, 0.0, 1.0)[..., None]
    p00 = img[y0, x0]
    p01 = img[y0, x0 + 1]
    p10 = img[y0 + 1, x0]
    p11 = img[y0 + 1, x0 + 1]
    return ((p00 * (1 - fx) + p01 * fx) * (1 - fy)
            + (p10 * (1 - fx) + p11 * fx) * fy)


def _rot_ypr(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Rz(roll) @ Rx(pitch) @ Ry(yaw)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cx, sx = np.cos(pitch), np.sin(pitch)
    cz, sz = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Rx @ Ry


def synthetic_rotation_pair(height: int = 480, width: int = 640,
                            yaw_deg: float = 10.0, pitch_deg: float = 1.0,
                            roll_deg: float = 1.5, seed: int = 7,
                            focal: float | None = None):
    """Two views of one planar scene from a purely rotating camera.

    Returns (img1, img2, H_true (3, 3) float64, focal) with
    H_true = K R2 R1^-1 K^-1 (view 1 -> view 2)."""
    f = float(focal if focal is not None else 0.9 * width)
    yaw = np.deg2rad(yaw_deg)
    extra = int(np.ceil(2.0 * f * np.tan(yaw) + 0.25 * width))
    sh, sw = height + height // 3, width + extra
    scene = _render_scene(sh, sw, seed).astype(np.float32)
    return rotation_views_of_scene(scene, height, width, f,
                                   yaw_deg, pitch_deg, roll_deg)


def rotation_views_of_scene(scene: np.ndarray, height: int, width: int,
                            focal: float, yaw_deg: float,
                            pitch_deg: float = 1.0, roll_deg: float = 1.5):
    """Render two rotating-camera views of a scene image.
    Returns (img1, img2, H_true (3, 3) float64, focal)."""
    f = float(focal)
    scene = np.asarray(scene, np.float32)
    sh, sw = scene.shape[:2]
    K = np.array([[f, 0, (width - 1) / 2.0],
                  [0, f, (height - 1) / 2.0],
                  [0, 0, 1.0]])
    Ks = np.array([[f, 0, (sw - 1) / 2.0],
                   [0, f, (sh - 1) / 2.0],
                   [0, 0, 1.0]])
    yaw = np.deg2rad(yaw_deg)
    R1 = _rot_ypr(-yaw / 2, 0.0, 0.0)
    R2 = _rot_ypr(yaw / 2, np.deg2rad(pitch_deg), np.deg2rad(roll_deg))

    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    ones = np.ones_like(xs)
    views = []
    for R in (R1, R2):
        M = Ks @ R.T @ np.linalg.inv(K)
        px = M[0, 0] * xs + M[0, 1] * ys + M[0, 2] * ones
        py = M[1, 0] * xs + M[1, 1] * ys + M[1, 2] * ones
        pz = M[2, 0] * xs + M[2, 1] * ys + M[2, 2] * ones
        views.append(np.clip(_bilinear_sample(scene, px / pz, py / pz),
                             0, 255).astype(np.uint8))
    H_true = K @ R2 @ R1.T @ np.linalg.inv(K)
    H_true = H_true / H_true[2, 2]
    return views[0], views[1], H_true, f
