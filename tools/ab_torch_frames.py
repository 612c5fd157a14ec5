"""A/B timing of the port's opaque frames on one CUDA card.

Draws, with the ``mdapy_tpu_torch`` and ``chip_smoke.py`` of the checkout
given as the first argument, the opaque frames that ``chip_smoke.py``
measures: the headline frame (phase 3), BASELINE config 2 (phase 5), config
3 (phase 4) and config 3 with its cell (phase 6), each at 1920x1080 through
``TachyonRender(backend="cuda").render(..., device_output=True)``.  For each
it prints the warm ms a frame (host clock over ``WARM_FRAMES`` frames after
one untimed frame) and the kernel's full-frame ms (CUDA events), as one
JSON line ``AB {...}`` labelled with the second argument.

Compare two commits by unpacking each into a directory (``git archive``)
and running them in turns on one card, e.g. parent, change, change, parent:

    python3 tools/ab_torch_frames.py path/to/parent parent
    python3 tools/ab_torch_frames.py path/to/change change
"""
import json
import os
import sys
import time

import numpy as np
import torch

if len(sys.argv) != 3:
    sys.exit("usage: ab_torch_frames.py CHECKOUT LABEL")
if not torch.cuda.is_available():
    sys.exit("ab_torch_frames.py needs a CUDA card")
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs  # noqa: E402
from mdapy_tpu_torch import TachyonRender, preset_camera  # noqa: E402
from mdapy_tpu_torch.render import megakernel  # noqa: E402
from mdapy_tpu_torch.render import render as trender  # noqa: E402
from mdapy_tpu_torch.render._build import load_all  # noqa: E402
from mdapy_tpu_torch.render.geometry import bond_edges, box_edges  # noqa: E402

load_all()
W, H = 1920, 1080
res = {"checkout": sys.argv[2], "card": torch.cuda.get_device_name(0)}


def warm(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cs.WARM_FRAMES):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / cs.WARM_FRAMES * 1e3


def kernel_ms(ren, S, other=False):
    _, fb, cd, lights, params = ren._accel
    kw = dict(S=S, tiles_x=fb.tiles_x, grid_n=32, eps=ren._cfg.eps,
              perspective=True, shadows=True)
    if other:
        kw["other"] = ren._other
    return cs.event_ms(lambda: megakernel.mega_render_cuda(
        cd, fb.sph_zmin, lights, params, 0, **kw), 5)


pos, colors, radii = cs.fcc_block(63)
cam = preset_camera("perspective", pos, max_radius=1.28)
ren = TachyonRender(backend="cuda", ao=False)
res["headline"] = (warm(lambda: ren.render(pos, colors, radii, camera=cam,
                                           width=W, height=H,
                                           device_output=True)),
                   kernel_ms(ren, 13))
del ren

fe = cs.bcc_system(6)
pos2 = fe.get_positions()
rad2 = np.full(fe.N, 0.5, np.float32)
cam2 = preset_camera("perspective", pos2, max_radius=0.5)
colors2 = trender._default_colors(fe)
cell2 = box_edges(fe.box)
bonds2 = bond_edges(pos2, fe.box, fe.bond, colors2, rad2, 0.2)[0]
ren = TachyonRender(backend="cuda", ao=False)
res["config2"] = (warm(lambda: ren.render(
    pos2, colors2, rad2, camera=cam2, bond_edges=bonds2, bond_radius=0.2,
    box_edges=cell2, width=W, height=H, device_output=True)),
    kernel_ms(ren, 13, other=True))
del ren

out = cs.voronoi_polycrystal()
pos3 = out[0] if isinstance(out, tuple) else out   # (positions, grain) or positions
col3 = np.tile(np.array([[0.78, 0.5, 0.2, 1.0]], np.float32), (len(pos3), 1))
rad3 = np.full(len(pos3), 1.28, np.float32)
cam3 = preset_camera("perspective", pos3, max_radius=1.28)
ren = TachyonRender(backend="cuda", ao=True, ao_samples=12, aa_samples=2,
                    background=(1.0, 1.0, 1.0))
res["config3"] = (warm(lambda: ren.render(pos3, col3, rad3, camera=cam3,
                                          width=W, height=H,
                                          device_output=True)),
                  kernel_ms(ren, 3))
edges = box_edges(cs.Cell(230.0))
res["config3_cell"] = (warm(lambda: ren.render(
    pos3, col3, rad3, camera=cam3, box_edges=edges, width=W, height=H,
    device_output=True)), kernel_ms(ren, 3, other=True))
print("AB " + json.dumps(res), flush=True)
