"""The fast-AO sky lights built each alone, the oracle of the batched
build (``render.build_ao_lights``), and the rules the batched build is held
to: ``tests/test_torch_ao_batched.py`` on the CPU and the card, and
``chip_smoke.py`` on the card.  Imports no jax.

Each light built alone is the same pass with K = 1: ``build_light_bins`` ->
``build_light_records``, its row from ``accel.light_rows``, and
``occluder_records`` where the scene has cylinders or rings.  A light's
cells must not depend on the lights built beside it: the batched build must
give each light's CSR offsets, counts and each cell's set of sphere ids
exactly, its records and cell key maxima within rtol 1e-6 with the keys
non-increasing in every cell, and its row and occluder table within rtol
1e-6.  The JAX build is the reference both are held to
(``tests/test_torch_ao.py``, ``tests/test_torch_accel.py``)."""

import numpy as np
import torch

from mdapy_tpu_torch.render import accel
from mdapy_tpu_torch.render import render as trender

RTOL = 1e-6


def sky_dirs(ao_samples: int) -> np.ndarray:
    """The 2 * (ao_samples // 2) sky directions, as ``build_ao_lights``
    takes them."""
    hemi = trender._fib_hemisphere(max(1, ao_samples // 2))
    return np.concatenate([hemi, -hemi], axis=0)


def each_alone(scene, ao_samples: int, ao_brightness: float, rmax: float,
               grid: int = 32, table=None) -> list:
    """[(LightBins, (lrow, lrec, loffs, lcnt, lkmax, occ))], each light
    built alone."""
    k2 = max(1, ao_samples // 2)
    lightcol = (4.0 / (2 * k2)) * float(ao_brightness)
    out = []
    for dk in sky_dirs(ao_samples):
        lb = accel.build_light_bins(scene, dk, grid=grid)
        rec = accel.build_light_records(lb, scene)
        occ = accel.occluder_records(table, lb) if table is not None else None
        row = accel.light_rows(dk, lb.frame, lightcol, rmax)[0]
        out.append((lb, (row, *rec, occ)))
    return out


def batched_bins(scene, ao_samples: int, grid: int = 32) -> list:
    """Each sky light's LightBins from the batched build, in one group."""
    batch = accel.frame_light_batch(scene, sky_dirs(ao_samples), grid)
    group = accel.bin_light_group(batch, range(len(batch.pairs)))
    return [accel.light_group_bins(batch, group, j)
            for j in range(len(batch.pairs))]


def _cell_sets(ids, count, n: int) -> torch.Tensor:
    """Each cell's sphere ids as cell * n + id, sorted (the ids lie by cell,
    back to back): equal tensors mean equal sets in every cell."""
    cell = torch.repeat_interleave(
        torch.arange(count.shape[0], device=count.device), count)
    return torch.sort(cell * n + ids.to(torch.int64)).values


def check_bins(got, ref, n: int) -> None:
    """One light's batched LightBins against the light's built alone."""
    assert torch.equal(got.offs, ref.offs)
    assert torch.equal(got.count, ref.count)
    assert torch.equal(_cell_sets(got.ids, got.count, n),
                       _cell_sets(ref.ids, ref.count, n))
    for name in ("L", "e1", "e2", "org", "inv_cell"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=RTOL, atol=0)
    torch.testing.assert_close(got.keys, ref.keys, rtol=RTOL, atol=0)


def check_light(got, ref) -> int:
    """One ``build_ao_lights`` entry against the light's built alone;
    returns its record count."""
    lrow, lrec, loffs, lcnt, lkmax, occ = got
    rrow, rrec, roffs, rcnt, rkmax, rocc = ref
    assert torch.equal(loffs, roffs) and loffs.dtype == torch.int32
    assert torch.equal(lcnt, rcnt) and lcnt.dtype == torch.int32
    assert lrec.shape == rrec.shape and lrec.dtype == torch.float32
    torch.testing.assert_close(lrec, rrec, rtol=RTOL, atol=0)
    torch.testing.assert_close(lkmax, rkmax, rtol=RTOL, atol=0)
    # keys non-increasing in every cell: no key rises from one record to
    # the next within a cell
    m = lrec.shape[0]
    if m > 1:
        same_cell = torch.ones(m - 1, dtype=torch.bool, device=lrec.device)
        starts = loffs.to(torch.int64)[(lcnt > 0) & (loffs > 0)]
        same_cell[starts - 1] = False
        rise = lrec[1:, 4] > lrec[:-1, 4]
        assert not bool((rise & same_cell).any())
    np.testing.assert_allclose(lrow, rrow, rtol=RTOL, atol=0)
    assert lrow.dtype == np.float32 and lrow.shape == (16,)
    assert (occ is None) == (rocc is None)
    if occ is not None:
        torch.testing.assert_close(occ, rocc, rtol=RTOL, atol=0)
    return m


def check_ao_lights(scene, lights, ao_samples: int, ao_brightness: float,
                    rmax: float, grid: int = 32, table=None) -> int:
    """``lights`` from ``build_ao_lights`` and the batched build's bins
    against each light built alone; returns the records compared."""
    ref = each_alone(scene, ao_samples, ao_brightness, rmax, grid, table)
    assert len(lights) == len(ref) == 2 * max(1, ao_samples // 2)
    n = scene.sph_center.shape[0]
    for got_lb, (ref_lb, _) in zip(batched_bins(scene, ao_samples, grid), ref):
        check_bins(got_lb, ref_lb, n)
    return sum(check_light(got, r) for got, (_, r) in zip(lights, ref))
