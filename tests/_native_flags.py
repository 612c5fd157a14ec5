"""Build switches for the native-engine parity tests
(``tests/test_torch_ptm.py``, ``test_torch_voronoi.py``,
``test_torch_sqs.py``).

``private_jax_build`` points the JAX package's ``load_library`` at a
directory of the calling test module's own.  The JAX package compiles each
engine into ``<tmp>/mdapy_tpu_native/<name>.so.tmp`` under a fixed name, so
two pytest workers that build the same engine at once write one file
(ROADMAP C17); a private directory keeps a worker's build its own.

``port_engine_flags`` makes the port's ``load_library`` build with the
given extra g++ flags, in a cache of its own.  The JAX package builds its
engines with ``-march=native``, the port without it (ROADMAP C16); with
that flag added the port's copies must give the JAX package's bits, which
shows that a difference without it comes from the flags alone.
"""

import contextlib

import mdapy_tpu.native as jax_native
import mdapy_tpu_torch.native as port_native

JAX_FLAGS = ["-march=native"]


def private_jax_build(tmp_path_factory):
    """Send the JAX package's engine builds (and its loaded-library cache)
    to a directory of this test module's own; returns the undo."""
    saved = (jax_native._BUILD, jax_native._cache)
    jax_native._BUILD = str(tmp_path_factory.mktemp("jax_native"))
    jax_native._cache = {}

    def undo():
        jax_native._BUILD, jax_native._cache = saved
    return undo


@contextlib.contextmanager
def port_engine_flags(extra, module=None, **engine_globals):
    """Within the block, the port's engines build with ``extra`` g++ flags
    (into their own file names: the flags are hashed) and load afresh; the
    ``engine_globals`` of ``module`` (its loaded engine) are set for the
    block and restored after it."""
    saved = (port_native.GXX_FLAGS, port_native._cache)
    saved_globals = {k: getattr(module, k) for k in engine_globals}
    port_native.GXX_FLAGS = saved[0] + list(extra)
    port_native._cache = {}
    for k, v in engine_globals.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        port_native.GXX_FLAGS, port_native._cache = saved
        for k, v in saved_globals.items():
            setattr(module, k, v)
