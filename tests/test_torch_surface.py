"""The port's module-level call surfaces against the JAX package's (ROADMAP
C11): the module-level twin of
``tests/test_torch_render.py::test_call_surface_matches_jax_renderer``.

For every JAX module that the port has ported, each name in its
``__all__`` must be an attribute of the port's module, and each name in
the JAX package's ``_LAZY`` must be in the port's, unless the omission is
written down below with its reason: TPU layout or a tuning knob that the
port drops on purpose, a dead name in a JAX ``__all__`` (C12),
``evaluate_jax`` (the port's is ``evaluate_torch``), or a module the port
has not reached yet, with the ROADMAP step that ports it.  An omission
that is no longer one (the port gained the name) fails too, so the list
stays true.  The package's entry points (the ``_LAZY`` names) must take
the JAX parameters in the JAX order, the port adding ``device`` and the
like after them; the module-level helpers below them may differ in their
parameters, where the port's tensors replace the TPU layout.
"""

import importlib
import inspect
import os

import pytest

import mdapy_tpu
import mdapy_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _has_all(sub: str, f: str) -> bool:
    path = os.path.join(REPO, "mdapy_tpu", sub, f)
    if not os.path.exists(path):
        return False
    with open(path) as fh:
        return "__all__ = " in fh.read()


# the JAX modules with an ``__all__`` that the port keeps under their names
PORTED = sorted(
    f"{sub}.{f[:-3]}"
    for sub in ("render", "neighbor", "potentials", "analysis", "core", "io",
                "utils", "build")
    for f in os.listdir(os.path.join(REPO, "mdapy_tpu_torch", sub))
    if f.endswith(".py") and f != "__init__.py" and _has_all(sub, f))

# a JAX module the port split in two: name -> port module
SPLIT = {
    "render.pallas_kernels": {
        "closest_hit_spheres_tiles": "render.tile_kernels",
        "shadow_filter_tiles": "render.tile_kernels",
        "gather_chunk_data": "render.gather",
        "gather_chunk_data_banded": "render.gather",
    },
}

# (JAX module, name) -> why the port does not have it
OMITTED = {
    ("render.accel", "KindBins"):
        "TPU layout: the per-kind dense (bucket, K) candidate table; the port "
        "keeps each tile's cylinders and rings back to back in ScreenBins",
    ("render.accel", "scene_live_counts"):
        "TPU layout: live counts size XLA's static shapes; the port's pair "
        "expansion needs none",
    ("render.tracer", "render_rays"):
        "C12: a dead name in the JAX __all__, no such function there",
    ("neighbor.cell_list", "neighbor_list_dense"):
        "TPU layout: the dense all-pairs route of small systems and its "
        "capacity bucketing (ROADMAP A8)",
    ("analysis.cluster_analysis", "connected_components_jax"):
        "TPU layout: jax's label propagation; the port's connected_components "
        "runs the same rounds in torch ops",
    ("analysis.common", "min_image_jnp"):
        "TPU layout: the jnp minimum image; the port's is common.min_image",
    ("analysis.common", "valid_mask"):
        "TPU layout: a jnp one-liner the port writes inline",
    ("analysis.common", "segment_mean_cols"):
        "TPU layout: jax.ops.segment_sum means; no ported analysis calls it",
}
# attributes of a class (JAX module, class, attribute) the port renames
RENAMED = {("utils.spline", "Spline", "evaluate_jax"): "evaluate_torch"}

# the JAX package's _LAZY names whose modules the port has not reached,
# by the ROADMAP step that ports them: none, the port exports every name
STEPS = {}


def _module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def test_ported_modules_are_found():
    assert len(PORTED) >= 40
    for name in ("core.system", "io.load_save", "io.trajectory", "utils.spline",
                 "potentials.nep", "render.render", "analysis.common",
                 "build.lattice", "build.polycrystal", "build.orthogonal_cell",
                 "analysis.structure_factor", "analysis.void_analysis",
                 "potentials.elastic", "potentials.bond_stiffness",
                 "potentials.qha_elastic", "potentials.lammps",
                 "potentials.md_elastic", "potentials.nep4ase",
                 "render.distributed", "render.multihost"):
        assert name in PORTED


@pytest.mark.parametrize("name", PORTED + sorted(SPLIT))
def test_module_all_matches_jax(name):
    jax_mod = _module("mdapy_tpu", name)
    names = jax_mod.__all__
    for attr in names:
        target = SPLIT.get(name, {}).get(attr, name)
        port_mod = _module("mdapy_tpu_torch", target)
        has = hasattr(port_mod, attr)
        why = OMITTED.get((name, attr))
        if why is None:
            assert has, f"mdapy_tpu_torch.{target} lacks {attr!r}"
        else:
            assert not has, f"{name}.{attr} is ported now: drop it from OMITTED"
    for (mod, attr), why in OMITTED.items():
        if mod == name:
            assert attr in names and why


def _same_parameters(j, t, what, module):
    """The JAX parameters, in order, lead the port's (which may add
    ``device`` and others after them); for a class, its ``__init__`` and
    each public method, apart from those in RENAMED."""
    if j is None or not callable(j):
        return
    if inspect.isclass(j):
        for meth, jm in vars(j).items():
            if not callable(jm) or (meth.startswith("_") and meth != "__init__"):
                continue
            new = RENAMED.get((module, j.__name__, meth))
            tm = getattr(t, new or meth, None)
            assert tm is not None, f"{what}.{meth} missing"
            if new is None:
                _same_parameters(jm, tm, f"{what}.{meth}", module)
        return
    try:
        jp = list(inspect.signature(j).parameters)
        tp = list(inspect.signature(t).parameters)
    except (TypeError, ValueError):
        return
    assert tp[:len(jp)] == jp, (what, jp, tp)


def test_renamed_attributes():
    for (mod, cls, old), new in RENAMED.items():
        assert hasattr(getattr(_module("mdapy_tpu", mod), cls), old)
        port_cls = getattr(_module("mdapy_tpu_torch", mod), cls)
        assert hasattr(port_cls, new) and not hasattr(port_cls, old)


def test_package_lazy_names_match_jax():
    jax_lazy, port_lazy = mdapy_tpu._LAZY, mdapy_tpu_torch._LAZY
    assert not set(port_lazy) - set(jax_lazy), "the port exports a name JAX lacks"
    for name, (module, _) in jax_lazy.items():
        if name in port_lazy:
            continue
        assert module in STEPS, f"{name} ({module}) is neither ported nor queued"
    for module, step in STEPS.items():
        assert not any(m == module for m, _ in port_lazy.values()), (
            f"{module} is exported by the port now: drop it from STEPS ({step})")


@pytest.mark.parametrize("name", sorted(mdapy_tpu_torch._LAZY))
def test_lazy_names_resolve(name):
    value = getattr(mdapy_tpu_torch, name)
    jax_value = getattr(mdapy_tpu, name)
    if inspect.ismodule(jax_value):
        assert inspect.ismodule(value)
        return
    module = mdapy_tpu._LAZY[name][0].lstrip(".")
    _same_parameters(jax_value, value, name, module)
