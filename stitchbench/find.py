"""Finding the benchmark's parts by name: `<folder>/<name>.py` under
`stitchbench/`, loaded by its path (a name may hold dots) and kept.

The folders: `drivers/` (a traffic mix's `"driver"`: how requests reach
the program), `poses/` (a mix's `"poses"`: the cameras of a pool item),
`surfaces/` (a configuration's reference surface), `metrics/` (one reader
per per-layer metric). A new one is a new file; nothing lists them.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
_loaded: dict[tuple[str, str], object] = {}


def part(folder: str, name: str):
    """The module `stitchbench/<folder>/<name>.py`."""
    key = (folder, name)
    if key not in _loaded:
        path = BENCH_DIR / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py in stitchbench "
                           f"({sorted(names(folder))})")
        spec = importlib.util.spec_from_file_location(
            f"stitchbench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def names(folder: str) -> list[str]:
    """Every part of a folder, by name (files starting with `_` are
    helpers)."""
    return sorted(p.stem for p in (BENCH_DIR / folder).glob("*.py")
                  if not p.name.startswith("_"))
