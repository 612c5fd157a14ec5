"""The image out (``mdapy_tpu_torch/render/image_out.py``): the frame's
float RGB to the (H, W, 4) uint8 RGBA image.

On the CPU, ``image_out_plain`` and ``TachyonRender(backend="cpu").render``
against the numpy pack that ``render`` ran before the image was built on
the render device (``_numpy_pack``, kept here as the oracle), and every
call's image a fresh array.  On the card (tests marked ``cuda``, skipped
without one), the hand kernel ``csrc/image_out.cu`` against
``image_out_plain`` byte for byte on float32 frames (every route renders in
float32 on the card; the kernel refuses float64), and the bytes ``render``
copies to the host; there this file runs alone:

    python3 -m pytest tests/test_torch_image_out.py --noconftest -q

It imports no jax, as the card's machine has none.
"""

import numpy as np
import pytest
import torch

import mdapy_tpu_torch
from mdapy_tpu_torch import tracing
from mdapy_tpu_torch.render import image_out
from mdapy_tpu_torch.render import render as trender
from mdapy_tpu_torch.render.config import quantize

SIZES = [(1, 1), (5, 3), (1023, 777)]
# the middle channel lands on a half level (102.5), so some pixels sit
# exactly 1.5 from the background
BACKGROUND = (0.2, 102.5 / 255.0, 0.6)
# (transparent, the background's alpha)
MODES = [(t, a) for t in (False, True) for a in (0.0, 0.5, 1.0)]


def _numpy_pack(img_f, height, width, bg_a, transparent, background):
    """The host pack ``TachyonRender.render`` ran before the RGBA image was
    built on the render device, line for line."""
    rgb = quantize(img_f).cpu().numpy()
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[:, :, :3] = rgb
    img[:, :, 3] = np.uint8(max(0.0, min(1.0, bg_a)) * 255.0 + 0.5)
    if transparent:
        bg = np.array(background, dtype=np.float32) * 255.0
        diff = np.abs(img[:, :, :3].astype(np.float32) - bg).max(axis=2)
        img[:, :, 3] = np.where(diff < 1.5, 0, 255).astype(np.uint8)
    return img


def _args(transparent, bg_a, background=BACKGROUND):
    """``image_out_rgba``'s alpha byte and background, as ``render`` takes
    them."""
    alpha = int(np.uint8(max(0.0, min(1.0, bg_a)) * 255.0 + 0.5))
    bg = np.array(background, dtype=np.float32) * 255.0 if transparent else None
    return alpha, bg


def _values(dtype):
    """Every k/255 in ``dtype`` (also as float32 k / 255), the values on
    either side of each, their negatives, values above 1, +-inf, and pixels
    within a few levels of the background in every channel."""
    k = np.arange(256)
    exact = np.concatenate([(k / 255.0).astype(dtype),
                            (k.astype(np.float32) / np.float32(255)).astype(dtype)])
    up = np.nextafter(exact, np.array(np.inf, dtype))
    down = np.nextafter(exact, np.array(-np.inf, dtype))
    pool = np.concatenate([exact, up, down, -exact, -up, 1.0 + exact, 2.0 + up,
                           np.array([1e30, -1e30, 255.0, np.inf, -np.inf])])
    near = np.array(BACKGROUND, np.float64) * 255.0
    steps = np.array([-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0])
    d = np.stack(np.meshgrid(steps, steps, steps, indexing="ij"), -1).reshape(-1, 3)
    return pool.astype(dtype), ((near + d) / 255.0).astype(dtype)


def _frame(height, width, dtype, seed=0):
    """An (H, W, 3) frame of ``_values``: the whole pool where it fits, the
    rest uniform in [-0.1, 1.1]; the background's neighbours as whole pixels."""
    rng = np.random.default_rng(seed)
    pool, near = _values(dtype)
    n = height * width
    flat = rng.uniform(-0.1, 1.1, (n, 3)).astype(dtype)
    vals = rng.permutation(pool)[:n * 3]
    flat.reshape(-1)[rng.permutation(n * 3)[:len(vals)]] = vals
    m = min(len(near), n // 2)
    flat[rng.permutation(n)[:m]] = near[:m]
    return torch.from_numpy(flat.reshape(height, width, 3))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("transparent,bg_a", MODES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("height,width", SIZES)
def test_plain_equals_the_numpy_pack(height, width, dtype, transparent, bg_a):
    img_f = _frame(height, width, dtype)
    want = _numpy_pack(img_f, height, width, bg_a, transparent, BACKGROUND)
    got = image_out.image_out_plain(img_f, *_args(transparent, bg_a))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (height, width, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU frame takes the plain version through the dispatcher
    np.testing.assert_array_equal(
        image_out.image_out_rgba(img_f, *_args(transparent, bg_a)).numpy(), want)


def test_plain_frames_hit_both_alpha_values():
    """The transparent cases hold background pixels (alpha 0) and others."""
    img = image_out.image_out_plain(_frame(1023, 777, np.float32),
                                    *_args(True, 1.0)).numpy()
    assert {0, 255} == set(np.unique(img[:, :, 3]).tolist())


def _scene(n=2):
    a = 3.615
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).T
    pos = (frac[None] + cells[:, None]).reshape(-1, 3) * a
    rng = np.random.default_rng(5)
    colors = np.c_[rng.uniform(0.2, 1.0, (len(pos), 3)), np.ones(len(pos))]
    return pos, colors.astype(np.float32), np.full(len(pos), 1.28, np.float32)


def _spy(monkeypatch):
    """Records each frame ``render`` hands the image out."""
    frames = []
    real = trender.image_out_rgba

    def spy(img_f, *args):
        frames.append(img_f.clone())
        return real(img_f, *args)

    monkeypatch.setattr(trender, "image_out_rgba", spy)
    return frames


@pytest.mark.parametrize("transparent,bg_a", MODES)
def test_cpu_render_equals_the_numpy_pack(monkeypatch, transparent, bg_a):
    """``render`` on the CPU backend returns the old pack's bytes of its
    frame, with its background's alpha and the transparent background."""
    frames = _spy(monkeypatch)
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False,
                                        background=(*BACKGROUND, bg_a))
    img = ren.render(*_scene(), width=32, height=24, transparent=transparent)
    assert isinstance(img, np.ndarray) and len(frames) == 1
    want = _numpy_pack(frames[0], 24, 32, bg_a, transparent, BACKGROUND)
    np.testing.assert_array_equal(img, want)
    if transparent:
        assert {0, 255} <= set(np.unique(img[:, :, 3]).tolist())


def test_each_call_returns_a_fresh_array():
    """A later call leaves an earlier call's image as it was: no host
    buffer is shared between calls (a movie writer keeps every frame)."""
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cpu", ao=False)
    first = ren.render(pos, colors, radii, width=32, height=24)
    kept = first.copy()
    # another picture: the colours reversed (a shifted copy of the block
    # would not do, as the camera follows it and the frame comes out the same)
    second = ren.render(pos, colors[::-1].copy(), radii, width=32, height=24)
    third = ren.render(pos, colors, radii, width=32, height=24)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(third, kept)
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first, third)


# ---------------------------------------------------------------- card

def _layout(img_f, layout, dev):
    """The frame on the card as ``layout`` lays it out."""
    if layout == "f32":
        return img_f.to(dev)
    if layout == "transposed":   # not contiguous: the wrapper copies it
        return img_f.transpose(0, 1).contiguous().to(dev).transpose(0, 1)
    off = int(layout.split("+")[1])   # a view off a 16-byte boundary by `off` values
    buf = torch.empty(img_f.numel() + off, dtype=img_f.dtype, device=dev)
    view = buf[off:].view(img_f.shape)
    view.copy_(img_f.to(dev))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", "f32+1", "f32+3", "f32+4",
                                    "transposed"])
@pytest.mark.parametrize("height,width", SIZES)
def test_kernel_equals_plain(card, height, width, layout):
    img_f = _frame(height, width, np.float32, seed=height)
    x = _layout(img_f, layout, card)
    assert torch.equal(x.cpu(), img_f)
    for transparent, bg_a in MODES:
        args = _args(transparent, bg_a)
        image_out.reset_launches()
        got = image_out.image_out_rgba(x, *args)
        torch.cuda.synchronize()
        assert image_out.launches["image_out_rgba"] == 1
        assert got.device.type == "cuda" and got.is_contiguous()
        want = image_out.image_out_plain(img_f, *args)
        assert torch.equal(got.cpu(), want), (layout, transparent, bg_a)


@pytest.mark.cuda
def test_kernel_refuses_float64(card):
    with pytest.raises(ValueError, match="float32"):
        image_out.image_out_rgba(_frame(5, 3, np.float64).to(card), *_args(False, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("transparent", [False, True])
def test_card_render_takes_the_kernel(card, monkeypatch, transparent):
    """``render`` on the card returns the plain version's bytes of its
    frame through one kernel launch a call, and a fresh array each call;
    each host image counts its H·W·4 copied bytes, a ``device_output`` call
    none."""
    frames = _spy(monkeypatch)
    pos, colors, radii = _scene()
    ren = mdapy_tpu_torch.TachyonRender(backend="cuda", ao=False,
                                        background=(*BACKGROUND, 0.5))
    image_out.reset_launches()
    with tracing.recording() as rec:
        imgs = [ren.render(pos + s, colors, radii, width=32, height=24,
                           transparent=transparent) for s in (0.0, 0.9)]
        ren.render(pos, colors, radii, width=32, height=24, device_output=True)
    assert image_out.launches["image_out_rgba"] == 2
    calls = sorted({s.call for s in rec.spans})
    assert len(calls) == 3 and rec.counters[calls[0]]["image_out.fetch_bytes"] == 24 * 32 * 4
    assert rec.counters[calls[1]]["image_out.fetch_bytes"] == 24 * 32 * 4
    assert "image_out.fetch_bytes" not in rec.counters.get(calls[2], {})
    for img, frame in zip(imgs, frames):
        want = image_out.image_out_plain(frame.cpu(), *_args(transparent, 0.5))
        np.testing.assert_array_equal(img, want.numpy())
    assert not np.shares_memory(*imgs)
