"""The JAX package's sphere hit in the port's plain megakernel, for the
tests that hold the port's passes to the JAX kernel's.

The JAX kernel tests a sphere by b^2 - (|oc|^2 - r^2) in float32 and shades
and walks from o + t d.  With the camera tens of Angstrom away that puts
its hit points up to ~1e-4 A off their spheres and breaks ties at seams by
rounding; the port's walk takes the stable discriminant r^2 - |w|^2 and puts
each hit point back on its sphere (``tests/test_torch_sphere_hit.py`` holds
that to a float64 reference).  ``jax_sphere_hit(monkeypatch)`` gives the
plain version the JAX kernel's form again (``_closest_hit(stable=False)``,
the tiled tracer's kernel's form, and the hit point o + t d), so that a
comparison with the JAX kernel measures the passes' logic (lights, walks,
peels, the AA mean, the bands) at the bounds it always had; without
``monkeypatch`` (in a spawned rank) it sets them for the process.
"""

import functools

from mdapy_tpu_torch.render import megakernel


def jax_sphere_hit(monkeypatch=None) -> None:
    put = setattr if monkeypatch is None else monkeypatch.setattr
    put(megakernel, "_closest_hit",
        functools.partial(megakernel._closest_hit, stable=False))
    put(megakernel, "_on_sphere", lambda h, rec, n, sph: h)
