"""The port's public API against the JAX package's, by name and parameter.

Three checks, each a parametrised test so that every case counts:

1. per module of `imagestitch_tpu/`: every public function or class
   defined there (jitted programs included) has a counterpart of the same
   name in the port's module at the same path (a Pallas module
   `ops/pallas_<k>.py` maps to `ops/cuda_<k>.py`), and so has every public
   method of a class; every parameter of the JAX signature is in the
   port's signature (`*args` and `**kwargs` by kind);
2. per subpackage `__init__.py`: every name of the JAX subpackage's
   `__all__` imports from the port's subpackage and is in its `__all__`;
3. per entry of `DECLARED`, the differences kept on purpose: each item
   still exists on the JAX side and is still missing from the port (or,
   for a renamed name, its port counterpart exists), so the table cannot
   rot.
"""

import importlib
import inspect
from dataclasses import dataclass, field
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the JAX package's modules import it)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "imagestitch_tpu"


@dataclass(frozen=True)
class Declared:
    """A difference kept on purpose. `items`: JAX-side "module:name" (a
    name) or "module:name(param)" (a parameter) -> what the port has in
    its place: "port_module:port_name" for a name it has under another
    name, None for a name it does not have, a description for a
    parameter."""
    items: dict = field(default_factory=dict)
    reason: str = ""


_KEYED = ["geometry.affine:find_affine", "geometry.ransac:find_homography",
          "matching.matcher:match_pair", "matching.matcher:match_all",
          "parallel.pano:stitch_chain_pano_impl",
          "parallel.pano:stitch_chain_pano",
          "parallel.pano:stitch_pair_hostseam_sharded",
          "parallel.pano:stitch_chain_pano_sharded",
          "pipeline:stitch_pair_front_impl", "pipeline:stitch_pair_impl",
          "pipeline:stitch_chain_front_impl", "pipeline:stitch_chain_impl",
          "pipeline:stitch_pair_core", "pipeline:stitch_chain_core",
          "pipeline:stitch_chain_front", "pipeline:stitch_pair_front"]
_BATCH = ["parallel.batch:stitch_pairs_batched",
          "parallel.batch:stitch_pairs_sharded"]
_CONFIGURED = _BATCH + ["parallel.pano:stitch_chain_pano",
                        "parallel.pano:stitch_pair_hostseam_sharded",
                        "parallel.pano:stitch_chain_pano_sharded"]

DECLARED = {
    "shard_hint": Declared(
        {"parallel.mesh:shard_hint": None},
        "a sharding constraint for XLA's SPMD partitioner; PyTorch has no "
        "partitioner, and a no-op would claim a layout the port does not "
        "make (ROADMAP.md, 'No canvas-row split')"),
    "random_keys": Declared(
        {**{f"{k}(key)": "generator / draws / seed" for k in _KEYED},
         **{f"{k}(keys)": "seed / draws" for k in _BATCH}},
        "jax.random keys have no torch counterpart: the draws come from a "
        "torch.Generator (`generator`, or one seeded with `seed` on the "
        "device), or are injected as `draws`, which the tests take from "
        "jax.random"),
    "cfg_config": Declared(
        {f"{k}(cfg)": "config" for k in _CONFIGURED},
        "the port's host entry points all name their configuration "
        "`config`, as stitch_pair, stitch_chain and stitch do in both "
        "packages"),
    "use_pallas": Declared(
        {"warp.warper:warp_image(use_pallas)": "use_kernel"},
        "the kernel is CUDA, not Pallas: `use_kernel` has the same three "
        "values, and True raises off the card, where the kernel has no "
        "interpret mode"),
    "dp_chunk": Declared(
        {"seam.dp:dp_seam_path(chunk)": None},
        "the rows one lax.scan step takes, a knob that amortizes the "
        "scan's per-step cost in XLA and leaves the result as it is; the "
        "port's row loop has no scan step to size"),
    "sift_taps": Declared(
        {"ops.pallas_sift:octave_taps": "ops.cuda_sift:octave_blurs",
         "ops.pallas_sift:octave_halo": "ops.cuda_sift:octave_halos"},
        "the Pallas kernel bakes the tap values and one halo into its "
        "program; the CUDA kernel takes each blur's (ksize, sigma) and a "
        "halo per level"),
    "kernel_wrappers": Declared(
        {"ops.pallas_detect:detect_maps": "ops.cuda_detect:detect_maps",
         "ops.pallas_warp:pallas_warp_batched": "ops.cuda_warp:warp_batched",
         "ops.pallas_warp:pallas_warp": "ops.cuda_warp:warp"},
        "the Pallas kernels' wrappers are the CUDA kernels' wrappers, in "
        "the cuda_ modules, without the pallas_ prefix"),
    "interpret_row_rebase": Declared(
        {"ops.pallas_detect:detect_maps(interpret)": None,
         "ops.pallas_sift:sift_octave_maps(interpret)": None,
         "ops.pallas_warp:pallas_warp_batched(interpret)": None,
         "ops.pallas_warp:pallas_warp_batched(row_rebase)": None,
         "ops.pallas_warp:pallas_warp(interpret)": None,
         "ops.pallas_warp:pallas_warp(row_rebase)": None},
        "`interpret` runs a Pallas kernel in the CPU interpreter: a CUDA "
        "kernel has none, and a wrapper given a CPU tensor runs the plain "
        "version; `row_rebase` is a switch of the TPU kernel's slab "
        "layout that the CUDA kernel has no counterpart of"),
    "warp_ablate": Declared(
        {"ops.pallas_warp:pallas_warp_batched(ablate)": None},
        "an experiment switch that compiles the TPU kernel with one of "
        "its phases (slab DMA, roll, accumulation) removed, its output "
        "garbage by design; the CUDA kernel has none of those phases"),
}


def _items():
    """(names, params): the declared JAX names -> port counterpart (or
    None), and the set of declared "module:name(param)" items."""
    names, params = {}, set()
    for d in DECLARED.values():
        for item, port in d.items.items():
            if "(" in item:
                params.add(item)
            else:
                names[item] = port
    return names, params


NAMES, PARAMS = _items()


def _jax_modules():
    """Dotted names below `imagestitch_tpu` of its modules ("" for the
    package itself)."""
    out = []
    for p in sorted(JAX_PKG.rglob("*.py")):
        parts = p.relative_to(JAX_PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _jax_modules()
SUBPACKAGES = [m for m in MODULES
               if (JAX_PKG / m.replace(".", "/") / "__init__.py").exists()]


def _port_module(mod: str) -> str:
    """The port's module at the same path; pallas_<k> -> cuda_<k>."""
    parts = mod.split(".") if mod else []
    if parts and parts[-1].startswith("pallas_"):
        parts[-1] = "cuda_" + parts[-1][len("pallas_"):]
    return ".".join(["imagestitch_tpu_torch", *parts])


def _jax(mod: str):
    return importlib.import_module(
        "imagestitch_tpu" + ("." + mod if mod else ""))


def _public_defined(module):
    """Public callables defined in `module` itself (jitted programs and
    cached functions carry the module of the function they wrap)."""
    return {n: o for n, o in vars(module).items()
            if not n.startswith("_") and callable(o)
            and not inspect.ismodule(o)
            and getattr(o, "__module__", None) == module.__name__}


def _public_methods(cls):
    return {n: o for n, o in vars(cls).items()
            if not n.startswith("_") and callable(o)}


def _missing_params(jfn, tfn, key: str) -> list[str]:
    """JAX parameters of `jfn` that `tfn` lacks and DECLARED does not
    list (`*args` and `**kwargs` are matched by kind)."""
    jsig = inspect.signature(jfn).parameters
    tsig = inspect.signature(tfn).parameters
    tkinds = {p.kind for p in tsig.values()}
    out = []
    for name, p in jsig.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            ok = p.kind in tkinds
        else:
            ok = name in tsig or f"{key}({name})" in PARAMS
        if not ok:
            out.append(f"{key}({name})")
    return out


def _resolve(mod: str, name: str):
    """The port's counterpart of JAX `mod:name`, or None when DECLARED
    says the port has none; raises AttributeError when it is missing."""
    key = f"{mod}:{name}"
    if key in NAMES:
        if NAMES[key] is None:
            return None
        pmod, pname = NAMES[key].split(":")
        return getattr(importlib.import_module(
            "imagestitch_tpu_torch." + pmod), pname)
    return getattr(importlib.import_module(_port_module(mod)), name)


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "__init__")
def test_module_names_and_parameters(mod):
    """Every public function and class of the JAX module, and every public
    method of its classes, has a port counterpart taking every parameter
    it takes, less the declared differences."""
    gaps = []
    for name, jobj in sorted(_public_defined(_jax(mod)).items()):
        key = f"{mod}:{name}"
        try:
            tobj = _resolve(mod, name)
        except AttributeError:
            gaps.append(f"{key}: missing")
            continue
        if tobj is None:
            continue
        gaps += _missing_params(jobj, tobj, key)
        if inspect.isclass(jobj):
            for meth, jm in sorted(_public_methods(jobj).items()):
                tm = getattr(tobj, meth, None)
                if tm is None:
                    gaps.append(f"{key}.{meth}: missing")
                else:
                    gaps += _missing_params(jm, tm, f"{key}.{meth}")
    assert not gaps, gaps


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda m: m or "__init__")
def test_subpackage_exports(sub):
    """Every `__all__` name of the JAX subpackage imports from the port's
    and is in its `__all__`, less the names the port declares it lacks."""
    jsub = _jax(sub)
    tsub = importlib.import_module(_port_module(sub))
    gaps = []
    for name in jsub.__all__:
        obj = getattr(jsub, name)
        origin = getattr(obj, "__module__", "") or ""
        if origin.startswith("imagestitch_tpu."):
            key = f"{origin[len('imagestitch_tpu.'):]}:{name}"
            if key in NAMES and NAMES[key] is None:
                continue
        if name not in getattr(tsub, "__all__", ()):
            gaps.append(f"{name}: not in __all__")
        try:
            getattr(tsub, name)
        except AttributeError:
            gaps.append(f"{name}: does not import")
    assert not gaps, gaps


@pytest.mark.parametrize("entry", sorted(DECLARED))
def test_declared_difference_still_holds(entry):
    """Each declared item names a JAX name or parameter that exists, and
    the port still differs there: a renamed name has its counterpart and
    not the JAX name, an absent one is absent, a parameter is not taken
    by the counterpart."""
    decl = DECLARED[entry]
    assert decl.reason and decl.items
    for item, port in decl.items.items():
        key, _, param = item.partition("(")
        mod, name = key.split(":")
        jobj = getattr(_jax(mod), name)
        tmod = importlib.import_module(_port_module(mod))
        if param:
            param = param.rstrip(")")
            assert param in inspect.signature(jobj).parameters, item
            tobj = _resolve(mod, name)
            if tobj is not None:
                assert param not in inspect.signature(tobj).parameters, \
                    f"{item}: the port takes it now; drop the entry"
        elif port is None:
            assert not hasattr(tmod, name), \
                f"{item}: the port has it now; drop the entry"
        else:
            pmod, pname = port.split(":")
            assert hasattr(importlib.import_module(
                "imagestitch_tpu_torch." + pmod), pname), port
            if pname != name:
                assert not hasattr(tmod, name), \
                    f"{item}: the port has the JAX name too"
