"""ctypes bindings of the port's native host runtime (`imagestitch_tpu.
native.ccl`): 4-connected component labeling, seeded flood fill and
component statistics (ccl.cpp), Boykov-Kolmogorov min-cut on a pixel grid
(maxflow.cpp) and the exact dual shortest path of a seam corridor
(seamdual.cpp).

The three sources build with `g++ -O3 -shared -fPIC` into one library at
first use, in `build/native-<hash>/` beside the package (the directory
`.gitignore` lists); the hash covers the sources and the flags, so an
edited source builds a new library and an unchanged one is loaded again.
Nothing builds when the module is imported. Without g++ the functions
raise: the JAX package falls back to NumPy there, the port does not
(`have_native` asks whether the library builds and loads).
`_ccl_numpy` and `_flood_numpy` are the plain twins the tests hold the
native code against.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = ("ccl.cpp", "maxflow.cpp", "seamdual.cpp")
BUILD_DIR = HERE.parents[1] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIB_NAME = "libccl.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native seam runtime "
                           "(imagestitch_tpu_torch/native) cannot be built")
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-native-", dir=out_dir.parent))
    try:
        res = subprocess.run(
            [gxx, *GXX_FLAGS, *(str(HERE / s) for s in SOURCES), "-o",
             str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
        if res.returncode != 0:
            raise RuntimeError("g++ failed to build the native seam "
                               "runtime:\n" + res.stdout)
        try:
            tmp.rename(out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():   # lost a race only if
                raise                               # the other one won
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_path(build_root: Path | None = None) -> Path:
    """Where the library of the current sources and flags lives under
    `build_root` (default: `build/` beside the package)."""
    root = Path(build_root) if build_root is not None else BUILD_DIR
    return root / f"native-{_digest()}" / LIB_NAME


def load_library(build_root: Path | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises when g++ or
    the build fails. `build_root`: the directory the library is built in
    (default: `build/`); a process loads the library once, and a later
    call with another root only builds there."""
    global _lib
    if _lib is not None and build_root is None:
        return _lib
    with _lock:
        so = library_path(build_root)
        if not so.exists():
            _build(so.parent)
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(so))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.ccl_label.restype = ctypes.c_int32
        lib.ccl_label.argtypes = [u8p, i32p, i64, i64]
        lib.flood_fill.restype = ctypes.c_int64
        lib.flood_fill.argtypes = [u8p, i64, i64, i64, i64, ctypes.c_uint8,
                                   ctypes.c_uint8]
        lib.ccl_stats.restype = None
        lib.ccl_stats.argtypes = [i32p, i64, i64, ctypes.c_int32, i64p,
                                  i32p]
        lib.grid_maxflow.restype = ctypes.c_double
        lib.grid_maxflow.argtypes = [f32p, f32p, i64, i64, u8p]
        lib.band_dijkstra.restype = ctypes.c_double
        lib.band_dijkstra.argtypes = [f32p, f32p, i64, i64, u8p]
        _lib = lib
        return _lib


def have_native() -> bool:
    """Whether the native library builds (or is built) and loads here. A
    query only: without it the native functions still raise."""
    try:
        load_library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def connected_components(mask: np.ndarray):
    """4-connected labeling. mask: (H, W) bool/uint8. Returns
    (labels int32 (H, W) with 0 = background, n_components)."""
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    labels = np.zeros((h, w), np.int32)
    n = load_library().ccl_label(_ptr(m, ctypes.c_uint8),
                                 _ptr(labels, ctypes.c_int32), h, w)
    return labels, int(n)


def flood_fill(img: np.ndarray, seed_yx, value: int, new_val: int):
    """In-place seeded 4-connected flood fill of the pixels equal to
    `value` with `new_val`. Returns the filled pixel count."""
    a = np.ascontiguousarray(img.astype(np.uint8))
    h, w = a.shape
    n = load_library().flood_fill(_ptr(a, ctypes.c_uint8), h, w,
                                  int(seed_yx[0]), int(seed_yx[1]),
                                  int(value), int(new_val))
    img[...] = a
    return int(n)


def component_stats(labels: np.ndarray, n: int):
    """Pixel counts + inclusive bounding boxes per component.
    Returns (counts (n,) int64, boxes (n, 4) int32 [x0, y0, x1, y1])."""
    lab = np.ascontiguousarray(labels.astype(np.int32))
    h, w = lab.shape
    counts = np.zeros((n,), np.int64)
    boxes = np.zeros((n, 4), np.int32)
    if n > 0:
        load_library().ccl_stats(_ptr(lab, ctypes.c_int32), h, w, n,
                                 _ptr(counts, ctypes.c_int64),
                                 _ptr(boxes, ctypes.c_int32))
    return counts, boxes


def grid_maxflow(tcap: np.ndarray, ecap: np.ndarray):
    """BK min-cut on an (H, W) 4-neighbor grid.

    tcap: (H, W) float32 terminal capacities (>0 source, <0 sink);
    ecap: (H, W, 4) float32 directed edge capacities (left, right, up,
    down). Returns (labels (H, W) uint8, 1 = source side; flow value)."""
    t = np.ascontiguousarray(tcap, np.float32)
    e = np.ascontiguousarray(ecap, np.float32)
    h, w = t.shape
    lab = np.zeros((h, w), np.uint8)
    flow = load_library().grid_maxflow(
        _ptr(t, ctypes.c_float), _ptr(e, ctypes.c_float), h, w,
        _ptr(lab, ctypes.c_uint8))
    return lab, float(flow)


def band_dijkstra(vcost: np.ndarray, hcost: np.ndarray):
    """Exact min-cut of a vertical seam corridor via the planar dual:
    Dijkstra over the (H+1) x (W+1) pixel-corner lattice.

    vcost: (H, W+1) float32, the cost of cutting between pixels (y, x-1)
    and (y, x) (corner column x); hcost: (H+1, W) float32, between pixels
    (y-1, x) and (y, x) (corner row y). Returns (crossings (H, W+1) uint8,
    1 where the cut separates pixel x-1 from x in row y; the cut cost)."""
    v = np.ascontiguousarray(vcost, np.float32)
    hh = np.ascontiguousarray(hcost, np.float32)
    h = v.shape[0]
    w = v.shape[1] - 1
    if hh.shape != (h + 1, w):
        raise ValueError(f"hcost {hh.shape} does not fit vcost {v.shape}")
    cr = np.zeros((h, w + 1), np.uint8)
    cost = load_library().band_dijkstra(
        _ptr(v, ctypes.c_float), _ptr(hh, ctypes.c_float), h, w,
        _ptr(cr, ctypes.c_uint8))
    return cr, float(cost)


# --- plain twins of the labeling and the flood fill --------------------------

def _ccl_numpy(m: np.ndarray):
    """Labels in raster order of each component's first pixel, as the
    native labeling numbers them."""
    h, w = m.shape
    labels = np.zeros((h, w), np.int32)
    n = 0
    for y in range(h):
        for x in range(w):
            if m[y, x] and labels[y, x] == 0:
                n += 1
                stack = [(y, x)]
                labels[y, x] = n
                while stack:
                    cy, cx = stack.pop()
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        ny, nx = cy + dy, cx + dx
                        if (0 <= ny < h and 0 <= nx < w and m[ny, nx]
                                and labels[ny, nx] == 0):
                            labels[ny, nx] = n
                            stack.append((ny, nx))
    return labels, n


def _flood_numpy(img: np.ndarray, seed_yx, value: int, new_val: int):
    h, w = img.shape
    sy, sx = int(seed_yx[0]), int(seed_yx[1])
    if not (0 <= sy < h and 0 <= sx < w) or img[sy, sx] != value \
            or value == new_val:
        return 0
    stack = [(sy, sx)]
    img[sy, sx] = new_val
    count = 1
    while stack:
        cy, cx = stack.pop()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < h and 0 <= nx < w and img[ny, nx] == value:
                img[ny, nx] = new_val
                count += 1
                stack.append((ny, nx))
    return count
