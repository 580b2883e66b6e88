"""Device meshes (`imagestitch_tpu.parallel.mesh`): named axes of devices
that the sharded entry points split their work over.

PyTorch has no SPMD partitioner, so a mesh here only names devices, and
the sharded entry points split by hand what is independent:
- axis "data": views (detect, warp) and pairs (matching, the chain's pair
  seams, the pairs of a batch), each device taking its contiguous chunk
  (`data_sharding`);
- axis "model": the RANSAC hypotheses of one pair, scored in contiguous
  chunks, one on each device of the axis (`geometry.ransac.
  score_hypotheses`), under the mesh that `use_mesh` makes active.
The global stages (bundle adjustment, exposure, blend, the host seam's
readback) run on the mesh's first device after one gather. There is no
`shard_hint`: with no partitioner there is no layout to hint, and its
callers in the JAX package are the explicit splits above.

A mesh may name one device more than once: `[torch.device("cpu")] * 8` is
the CPU tests' counterpart of the JAX tests' 8-device virtual CPU mesh,
and a card named twice runs the split, the gathers and the per-shard
launches on one card. Shards on one device run one after another in the
calling thread; shards on distinct devices run at once, one worker thread
per device (`run_on_devices`).
"""

from __future__ import annotations

import contextlib
import contextvars
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "imagestitch_tpu_torch_mesh", default=None)


@dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device whose shape is the axis
    sizes, in the order of `axis_names`."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    def first(self) -> torch.device:
        """The device the global stages run on."""
        return self.devices.flat[0]

    def axis_devices(self, name: str) -> list[torch.device]:
        """The devices along axis `name` at index 0 of every other axis;
        the first device alone when the mesh has no such axis."""
        if name not in self.axis_names:
            return [self.first()]
        ax = self.axis_names.index(name)
        sel = tuple(slice(None) if a == ax else 0
                    for a in range(len(self.axis_names)))
        return list(self.devices[sel])

    def row(self, name: str, i: int) -> "Mesh":
        """The sub-mesh at index `i` of axis `name` (which it keeps, with
        size 1): the devices that serve shard i of that axis."""
        if name not in self.axis_names:
            return self
        ax = self.axis_names.index(name)
        return Mesh(np.take(self.devices, [i], axis=ax), self.axis_names)


def _canonical(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """A Mesh of {"axis": size} over `devices` (default: every CUDA
    device; with no card it raises). `devices` may repeat an entry: the
    shards on one device run one after another."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] * n to "
                "build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(sizes), names)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make `mesh` the active mesh inside the block (`jax.sharding.
    set_mesh`); the RANSAC engines read its "model" axis."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh() -> Mesh | None:
    """The active mesh, or None (`jax.sharding.get_mesh`)."""
    return _ACTIVE.get()


def model_devices() -> list[torch.device]:
    """The active mesh's "model" devices at index 0 of its other axes
    (a sharded entry point activates each data shard's row); [] with no
    active mesh."""
    mesh = current_mesh()
    return [] if mesh is None else mesh.axis_devices("model")


def chunk_ranges(n: int, k: int) -> list[tuple[int, int]]:
    """[start, stop) of k contiguous chunks of n items, sizes differing by
    at most one, the larger first (some empty when n < k)."""
    q, r = divmod(n, k)
    out, a = [], 0
    for i in range(k):
        b = a + q + (1 if i < r else 0)
        out.append((a, b))
        a = b
    return out


@dataclass(frozen=True)
class DataSharding:
    """Dim `dim` of `ndim`-dimensional tensors split over `devices` in
    contiguous chunks, the rest whole (`NamedSharding(mesh, P(..., axis,
    ...))`)."""

    devices: tuple[torch.device, ...]
    ndim: int
    dim: int = 0

    def ranges(self, n: int) -> list[tuple[int, int]]:
        return chunk_ranges(n, len(self.devices))

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Each device's contiguous chunk of `x`, on that device."""
        if x.ndim != self.ndim:
            raise ValueError(f"sharding of {self.ndim}-d tensors got a "
                             f"{x.ndim}-d one")
        return [x.narrow(self.dim, a, b - a).to(dev)
                for dev, (a, b) in zip(self.devices,
                                       self.ranges(x.shape[self.dim]))]

    def gather(self, parts, device) -> torch.Tensor:
        """The chunks concatenated in order on `device`."""
        return torch.cat([p.to(device) for p in parts], dim=self.dim)


def data_sharding(mesh: Mesh, ndim: int, axis_name: str = "data",
                  dim: int = 0) -> DataSharding:
    """Dim `dim` split over mesh axis `axis_name`, the rest whole."""
    return DataSharding(tuple(mesh.axis_devices(axis_name)), ndim, dim)


def _device_scope(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def run_on_devices(jobs):
    """Run [(device, fn)] and return [fn()] in order. The jobs of one
    device run one after another; jobs on distinct devices run at once,
    one worker thread per device, each under that device's CUDA context
    and the caller's active mesh."""
    groups: dict[torch.device, list[int]] = {}
    for i, (dev, _) in enumerate(jobs):
        groups.setdefault(dev, []).append(i)
    out = [None] * len(jobs)

    def run(idx):
        for i in idx:
            dev, fn = jobs[i]
            with _device_scope(dev):
                out[i] = fn()

    if len(groups) <= 1:
        for idx in groups.values():
            run(idx)
        return out
    with ThreadPoolExecutor(len(groups)) as ex:
        futures = [ex.submit(contextvars.copy_context().run, run, idx)
                   for idx in groups.values()]
        for f in futures:
            f.result()
    return out
