"""Builds the hand-written CUDA kernels of `imagestitch_tpu_torch/csrc`
into one shared library with a plain C interface, loaded with ctypes.

Each `.cu` source compiles to an object file with its own `nvcc` (all
started together), then one `nvcc -shared` links them. The library lives
in `build/kernels-<hash>/` beside the package (the directory `.gitignore`
lists); the hash covers the sources and the flags, so an edited source
builds a new library and an unchanged one is loaded again. Nothing here
runs when the module is imported: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the warp's sinf/cosf and divides stay IEEE-accurate;
# --fmad=false: every product rounds on its own, as in the plain versions
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libimagestitch_kernels.so"

_lib: ctypes.CDLL | None = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()
build_info: dict = {}


def count_launch(namespace: dict) -> None:
    """Add one to a wrapper module's `launch_count` (its `globals()`)
    under a lock: shards on distinct devices launch from their own threads
    (`parallel.mesh.run_on_devices`), and `+= 1` on a module global is a
    read, an add and a write that another thread can interleave."""
    with _count_lock:
        namespace["launch_count"] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, sources: list[Path]) -> str:
    """Compile every source in parallel, link one library; returns the
    compiler's log (ptxas register and shared-memory report included)."""
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    objs = [str(out_dir / (s.stem + ".o")) for s in sources]
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return "\n".join(log)


def library_path(build_root: Path | None = None) -> Path:
    """Where the library of the current sources and flags lives under
    `build_root` (default: `build/` beside the package)."""
    root = Path(build_root) if build_root is not None else BUILD_DIR
    return root / f"kernels-{_digest(_sources())}" / LIB_NAME


def load_library(build_root: Path | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. `build_root`: the
    directory the library is built in (default: `build/`); a process
    loads the library once, and a later call with another root only
    builds there. Raises when nvcc or the build fails; there is no
    fallback."""
    global _lib
    if _lib is not None and build_root is None:
        return _lib
    with _load_lock:
        sources = _sources()
        so = library_path(build_root)
        out_dir = so.parent
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            out_dir.parent.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=out_dir.parent))
            try:
                log = _compile(tmp, sources)
                (tmp / "build.log").write_text(log)
                try:
                    tmp.rename(out_dir)
                except OSError:
                    if not so.exists():   # lost a race only if the other
                        raise             # one won
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            built = True
        if _lib is not None:
            return _lib
        _lib = ctypes.CDLL(str(so))
        log_path = out_dir / "build.log"
        build_info.update(
            seconds=time.perf_counter() - t0, built=built, path=str(so),
            log=log_path.read_text() if log_path.exists() else "")
        return _lib


def check(status: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({cuda_error_name(status)})")


def cuda_error_name(status: int) -> str:
    lib = load_library()
    fn = lib.imagestitch_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(status).decode()
