"""The per-tile sphere records (``mdapy_tpu_torch/render/gather.py``): the
screen bins' (nb, nchunks, CH) ids to the (nb, nchunks, 8, CH) float32
records the megakernel and the tiled tracer read.

On the CPU, ``gather_chunk_data_plain`` and the dispatcher against a numpy
oracle bit for bit (random ids with -1 padding and all-padded chunks, CH not
a multiple of 32 or of 4, a one-sphere table, a table holding -0.0, inf and
NaN), and ``gather_chunk_data_banded`` over several bands against the one
shot.  On the card (tests marked ``cuda``, skipped without one), the hand
kernel ``csrc/chunk_gather.cu`` against the plain version byte for byte on
the same cases in several layouts and with ids and tables of other types,
on the render demo's own chunks at 3000x3000 (``hea32k_noao``'s first
snapshot and one of its ``viewpoints`` cameras), and
``gather_chunk_data_banded`` with bands against the one shot;
there this file runs alone:

    python3 -m pytest tests/test_torch_chunk_gather.py --noconftest -q

It imports no jax, as the card's machine has none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdapy_tpu_torch import CameraParams, tracing
from mdapy_tpu_torch.render import accel, gather, megakernel
from mdapy_tpu_torch.render.camera import camera_frame
from mdapy_tpu_torch.render.scene import build_scene

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# name -> (nb, nchunks, CH, table rows, share of padded slots)
CASES = {
    "padded": (7, 3, 128, 500, 0.3),
    "ch45": (5, 2, 45, 300, 0.2),
    "ch36": (4, 3, 36, 300, 0.2),
    "one_sphere": (6, 2, 128, 1, 0.5),
}


def _case(name, seed=0):
    """Ids with -1 padding (the last chunk of tile 1 and all of tile 2
    padded whole) and a table of random floats with -0.0, +-inf and a NaN
    among them."""
    nb, nchunks, ch, n, pad = CASES[name]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (nb, nchunks, ch))
    ids[rng.random(ids.shape) < pad] = -1
    ids[1, -1] = -1
    ids[2] = -1
    table = rng.uniform(-50.0, 50.0, (n, 8)).astype(np.float32)
    special = np.array([-0.0, np.inf, -np.inf, np.nan], np.float32)
    flat = table.reshape(-1)
    flat[rng.permutation(flat.size)[:min(4, flat.size)]] = special[:min(4, flat.size)]
    return torch.from_numpy(ids), torch.from_numpy(table)


def _oracle(ids, table):
    """The records by numpy indexing: row max(id, 0), r = -1 where id < 0."""
    ids, table = ids.numpy(), table.numpy()
    rec = table[np.maximum(ids, 0)]                  # (nb, nchunks, CH, 8)
    rec[..., 3] = np.where(ids >= 0, rec[..., 3], np.float32(-1.0))
    return np.ascontiguousarray(np.swapaxes(rec, -1, -2))


def _bits(x):
    """The float32 records as their raw 32-bit words."""
    return x.contiguous().view(torch.int32)


def _same_bytes(a, b) -> bool:
    return (a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            and torch.equal(_bits(a.cpu()), _bits(b.cpu())))


def _parts(table):
    """``gather_chunk_data``'s centers, radii and colors of a table."""
    return table[:, :3], table[:, 3], table[:, 4:]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_the_oracle(name):
    ids, table = _case(name)
    want = torch.from_numpy(_oracle(ids, table))
    assert int((ids < 0).all(dim=2).sum()) >= 1 + ids.shape[1]
    assert _same_bytes(gather.gather_chunk_data_plain(ids, table), want)
    # the CPU ids take the plain version through the dispatcher, counted
    gather.reset_launches()
    with tracing.recording() as rec:
        with tracing.span("render"):
            got = gather.gather_chunk_data(ids, *_parts(table), table=table)
    assert _same_bytes(got, want)
    assert gather.launches["chunk_gather"] == 0
    (counts,) = rec.counters.values()
    assert counts == {"accel.gather_bytes": want.numel() * 4}


def test_plain_packs_the_table_itself():
    ids, table = _case("padded", seed=1)
    got = gather.gather_chunk_data(ids, *_parts(table))
    assert _same_bytes(got, torch.from_numpy(_oracle(ids, table)))


@pytest.mark.parametrize("name", ["padded", "ch45"])
def test_banded_equals_one_shot_on_the_cpu(name):
    """A band of 2 tiles at a time: several bands, the same bytes."""
    ids, table = _case(name, seed=2)
    nb, nchunks, ch = ids.shape
    one = gather.gather_chunk_data(ids, *_parts(table))
    with tracing.recording() as rec:
        with tracing.span("render"):
            banded = gather.gather_chunk_data_banded(
                ids, *_parts(table), band_bytes=2 * nchunks * 8 * ch * 4)
    assert _same_bytes(banded, one)
    (counts,) = rec.counters.values()
    assert counts == {"accel.gather_bytes": one.numel() * 4}


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    ids, table = _case("padded")
    with pytest.raises(ValueError, match="needs CUDA ids"):
        gather.gather_chunk_data_cuda(ids, table)


# ---------------------------------------------------------------- card

def _layout(ids, table, layout, dev):
    """The ids and table on the card as ``layout`` lays them out."""
    if layout == "contiguous":
        return ids.to(dev), table.to(dev)
    if layout == "ids_off16":
        # ids one slot off a 16-byte boundary: the kernel's slot-a-thread path
        buf = torch.empty(ids.numel() + 1, dtype=ids.dtype, device=dev)
        view = buf[1:].view(ids.shape)
        view.copy_(ids.to(dev))
        return view, table.to(dev)
    if layout == "strided":
        # ids not contiguous, and a table whose rows are a view of wider rows
        tid = ids.transpose(0, 1).contiguous().to(dev).transpose(0, 1)
        wide = torch.zeros((table.shape[0], 9), dtype=table.dtype, device=dev)
        wide[:, 1:] = table.to(dev)
        return tid, wide[:, 1:]
    raise ValueError(layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "ids_off16", "strided"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_plain(card, name, layout):
    ids, table = _case(name, seed=3)
    d_ids, d_table = _layout(ids, table, layout, card)
    assert torch.equal(d_ids.cpu(), ids) and _same_bytes(d_table, table)
    gather.reset_launches()
    with tracing.recording() as rec:
        with tracing.span("render"):
            got = gather.gather_chunk_data(d_ids, *_parts(d_table), table=d_table)
    torch.cuda.synchronize()
    assert gather.launches["chunk_gather"] == 1
    (counts,) = rec.counters.values()
    assert counts == {"accel.gather_bytes": got.numel() * 4,
                      "accel.gather_launches": 1}
    assert got.device.type == "cuda" and got.is_contiguous()
    assert _same_bytes(got, gather.gather_chunk_data_plain(d_ids, d_table))
    assert _same_bytes(got, torch.from_numpy(_oracle(ids, table)))


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype,table_dtype",
                         [(torch.int32, torch.float32),
                          (torch.int64, torch.float64),
                          (torch.int32, torch.float16)],
                         ids=["int32_f32", "int64_f64", "int32_f16"])
def test_kernel_takes_every_card_gather(card, id_dtype, table_dtype):
    """Ids and tables of other types on the card go to the kernel too, cast
    as the plain version casts them, with the plain version's bytes.  The
    CPU comparison takes the table as the card casts it: a float16 NaN
    may widen to another float32 NaN on the CPU."""
    ids, table = _case("padded", seed=5)
    d_ids = ids.to(card, id_dtype)
    d_table = table.to(card, table_dtype)
    gather.reset_launches()
    got = gather.gather_chunk_data(d_ids, *_parts(d_table), table=d_table)
    torch.cuda.synchronize()
    assert gather.launches["chunk_gather"] == 1
    assert _same_bytes(got, gather.gather_chunk_data_plain(d_ids, d_table))
    assert _same_bytes(got, gather.gather_chunk_data_plain(
        ids, d_table.to(torch.float32).cpu()))


def _demo_chunks(dev, mix_name: str, camera_index: int):
    """The screen bins of ``hea32k_noao`` at 3000x3000 on the card: the first
    snapshot of ``mix_name`` seen from camera ``camera_index``."""
    from perfbench.drivers import render as bench

    config = json.loads((ROOT / "perfbench" / "configs" / "hea32k_noao.json")
                        .read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic" / f"{mix_name}.json")
                     .read_text())
    traffic = bench.inputs(config, mix, 2**31 + 22)
    r = config["render"]
    scene = build_scene(traffic.positions[0], traffic.colors, traffic.radii,
                        device=dev)
    cam = traffic.cameras[camera_index]
    camera = CameraParams(is_perspective=cam["is_perspective"],
                          field_of_view=cam["field_of_view"],
                          position=cam["position"], direction=cam["direction"],
                          up=cam["up"])
    frame = camera_frame(camera, r["width"], r["height"])
    bins = accel.build_screen_bins(scene, frame, r["width"], r["height"],
                                   megakernel.TILE_PX)
    return scene, bins


@pytest.mark.cuda
@pytest.mark.parametrize("mix_name,camera_index",
                         [("displaced_ring", 0), ("viewpoints", 2)],
                         ids=["snapshot", "viewpoint"])
def test_kernel_on_the_demo_chunks(card, mix_name, camera_index):
    """The demo's 32,000 atoms at 3000x3000: one launch, the plain
    version's bytes, and through ``gather_chunk_data_banded`` as the
    renderer calls it."""
    scene, bins = _demo_chunks(card, mix_name, camera_index)
    ids = bins.sph_chunks
    nb, nchunks, ch = ids.shape
    assert ch == 128 and nb * nchunks * ch > 4_000_000
    assert bool((ids < 0).any()) and bool((ids >= 0).any())
    # the kernel traps on an id past the table; the bins give none
    assert int(ids.max()) < scene.sph_center.shape[0]
    parts = (scene.sph_center, scene.sph_radius, scene.sph_color)
    table = gather.pack_sphere_table(*parts)
    gather.reset_launches()
    got = gather.gather_chunk_data(ids, *parts)
    banded = gather.gather_chunk_data_banded(ids, *parts)
    torch.cuda.synchronize()
    assert gather.launches["chunk_gather"] == 2
    want = gather.gather_chunk_data_plain(ids, table)
    assert _same_bytes(got, want) and _same_bytes(banded, want)


@pytest.mark.cuda
def test_banded_on_the_card_is_one_launch(card):
    """A band size that would cut the tiles into 4 bands: the kernel writes
    them all in one launch, equal to the plain one shot and to the plain
    banded gather on the CPU."""
    ids, table = _case("padded", seed=4)
    nb, nchunks, ch = ids.shape
    band = 2 * nchunks * 8 * ch * 4
    gather.reset_launches()
    got = gather.gather_chunk_data_banded(ids.to(card), *_parts(table.to(card)),
                                          band_bytes=band)
    torch.cuda.synchronize()
    assert gather.launches["chunk_gather"] == 1
    assert _same_bytes(got, gather.gather_chunk_data_plain(ids, table))
    assert _same_bytes(got, gather.gather_chunk_data_banded(
        ids, *_parts(table), band_bytes=band))
