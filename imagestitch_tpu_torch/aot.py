"""Ahead-of-time cache (`imagestitch_tpu.aot`): what a fresh process would
otherwise pay before its first stitch, built once at deploy time.

The JAX package serializes its whole jitted stitch program (jax.export),
so a fresh process skips tracing and compiling. The port's stitch cannot
be exported as one program: `torch.export` captures graphs of tensor
operations, and the stitch leaves the graph where its LM loop reads its
stop test back at every step (`geometry/bundle.py`), where it launches
its kernels through ctypes (`ops/cuda_build.py`) and where its host seams
run NumPy and C++. What a fresh port process pays instead is the build of
its two libraries: the CUDA kernels (nvcc) and the native seam runtime
(g++). So this module has two parts (ROADMAP Queue C):
- `cached_export`: `torch.export` programs (`.pt2`) on disk under the JAX
  package's key recipe, for functions that torch.export can capture;
- `stitch_pair_program`: both libraries built ahead of time into a named
  directory, and the pair stitch over them.

Keys hash the tag, the torch version, the device type and name, the
port's sources (`.py`, `.cpp`, `.cu`) and every argument's dtype and
shape, so a code, device or shape change builds anew; an unreadable or
stale blob is rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from pathlib import Path

import torch

__all__ = ["cached_export", "stitch_pair_program", "clear", "default_dir"]

PKG_DIR = Path(__file__).resolve().parent


def default_dir() -> str:
    """`build/exported` beside the package (a directory git ignores)."""
    return str(PKG_DIR.parent / "build" / "exported")


def _package_source_hash() -> str:
    """Hash of every .py, .cpp and .cu source of the port (sorted), so a
    code edit invalidates the cache."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(PKG_DIR)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith((".py", ".cpp", ".cu")):
                h.update(fn.encode())
                with open(os.path.join(dirpath, fn), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def _device_name(args) -> str:
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{dev.type}:{name}"


def _key(tag: str, args) -> str:
    h = hashlib.sha256()
    sig = ";".join(f"{a.dtype}{tuple(a.shape)}" if isinstance(a, torch.Tensor)
                   else repr(a) for a in args)
    for part in (tag, torch.__version__, _device_name(args),
                 _package_source_hash(), sig):
        h.update(str(part).encode())
        h.update(b"\0")
    return h.hexdigest()[:32]


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def cached_export(tag: str, fn, args: tuple, *, directory: str | None = None,
                  refresh: bool = False):
    """A callable equal to `fn` on tensors of `args`' shapes and dtypes,
    backed by a `torch.export` program on disk. Returns (call,
    was_cached): `was_cached` says whether the program came from disk.
    The blob is written atomically; an unreadable or stale one is
    rebuilt. A call with other shapes raises (the program's guards)."""
    directory = directory or default_dir()
    path = os.path.join(directory, f"{tag}-{_key(tag, args)}.pt2")
    if not refresh and os.path.exists(path):
        try:
            return torch.export.load(path).module(), True
        except Exception:   # noqa: BLE001
            # torch.export.load raises no one class for a blob it cannot
            # read (a zip error, a schema or version mismatch): rebuild
            pass
    ep = torch.export.export(_Fn(fn), tuple(args))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-",
                               suffix=".pt2")
    os.close(fd)
    try:
        torch.export.save(ep, tmp)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
    return ep.module(), False


def stitch_pair_program(h: int, w: int, cfg=None, *,
                        directory: str | None = None, refresh: bool = False,
                        device=None):
    """The pair stitch for (h, w, 3) views with both of its libraries built
    ahead of time under `directory`: the CUDA kernels on a card, the
    native seam runtime always. Returns (call, was_cached):
    `call(img1, img2, generator_or_draws)` -> `stitch_pair_impl`'s (pano,
    valid, corner, metrics) under `cfg`, the third argument a
    torch.Generator or (u_first, u_refit) draws; `was_cached` is true
    when both libraries were already on disk for the current sources and
    flags. `refresh` builds them anew. Runs on `device` (default: the CUDA
    card; with no card it raises)."""
    from imagestitch_tpu_torch.config import PipelineConfig
    from imagestitch_tpu_torch.native import ccl
    from imagestitch_tpu_torch.ops import cuda_build
    from imagestitch_tpu_torch.pipeline import (resolve_device,
                                                set_full_precision,
                                                stitch_pair_impl)

    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    root = Path(directory or default_dir())
    libs = [(ccl.library_path, ccl.load_library)]
    if dev.type == "cuda":
        libs.append((cuda_build.library_path, cuda_build.load_library))
    if refresh:
        for path, _ in libs:
            shutil.rmtree(path(root).parent, ignore_errors=True)
    was_cached = all(path(root).exists() for path, _ in libs)
    for _, load in libs:
        load(root)
    set_full_precision()

    def call(img1, img2, generator_or_draws=None):
        a = torch.as_tensor(img1, device=dev).to(torch.float32)
        b = torch.as_tensor(img2, device=dev).to(torch.float32)
        if tuple(a.shape) != (h, w, 3) or tuple(b.shape) != (h, w, 3):
            raise ValueError(f"the program stitches ({h}, {w}, 3) views, "
                             f"got {tuple(a.shape)} and {tuple(b.shape)}")
        if isinstance(generator_or_draws, torch.Generator):
            return stitch_pair_impl(a, b, cfg, generator=generator_or_draws)
        return stitch_pair_impl(a, b, cfg, draws=generator_or_draws)

    return call, was_cached


def clear(directory: str | None = None) -> int:
    """Delete the exported programs and the library directories under
    `directory`; returns how many were removed."""
    directory = directory or default_dir()
    n = 0
    if os.path.isdir(directory):
        for fn in os.listdir(directory):
            p = os.path.join(directory, fn)
            if fn.endswith(".pt2"):
                os.remove(p)
                n += 1
            elif fn.startswith(("kernels-", "native-")) and os.path.isdir(p):
                shutil.rmtree(p)
                n += 1
    return n
