"""mdapy_tpu_torch — the port of ``mdapy_tpu`` to PyTorch and CUDA.

The port goes slice by slice beside the JAX package, which stays the
reference it is tested against.  The slice ported so far is the renderer's
main path (``TachyonRender.render`` and ``render_system``): opaque spheres,
bond and box-edge cylinders, AA, one shadowed directional light and fast
ambient occlusion, with the frame rendered by a hand CUDA kernel for the
H100 (``csrc/mega_render.cu``).  This package imports torch and never jax,
nor anything of the JAX package.

Imports are lazy, in the style of ``mdapy_tpu/__init__.py``.
"""

__version__ = "0.1.0"

# name -> (module, attribute)
_LAZY = {
    "TachyonRender": (".render.render", "TachyonRender"),
    "CameraParams": (".render.camera", "CameraParams"),
    "preset_camera": (".render.camera", "preset_camera"),
    "auto_camera": (".render.camera", "auto_camera"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'mdapy_tpu_torch' has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(module_name, __name__)
    value = getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__ + ["__version__"]
