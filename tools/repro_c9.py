"""Repeatability of the megakernel's plain version on the CPU (ROADMAP C9).

Each run is a fresh process at ``--threads`` torch threads: it builds
``tests/_walk_scene.py``'s scene at 320x240 on the CPU (AA 2, AO 4,
shadows, the walk scene translucent at n_peel 4), calls
``megakernel.mega_render_plain`` three times on the same inputs, through
the orthographic camera of the scene and a perspective one, and prints one
JSON line: the pixels that differ between each pair of calls and the
largest difference.  With ``--hash`` it also hashes the inputs and outputs
of the plain version's inner functions (ray generation, the exit bound,
the closest hit, the shadow walks, the surfaces) in each call and names
the first that differs; with ``--dump DIR`` a run that differs saves that
function's arguments and outputs of every call there (``torch.save``).

    python3 tools/repro_c9.py --procs 24 --threads 8

runs 24 processes one after another and prints a summary line.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PAIRS = ((0, 1), (0, 2), (1, 2))


def one_run(threads: int, with_hash: bool, dump: str) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from _walk_scene import walk_scene
    from mdapy_tpu_torch.render import megakernel
    from mdapy_tpu_torch.render.camera import CameraParams
    from mdapy_tpu_torch.render.config import RenderConfig

    trace = []
    if with_hash:
        def digest(t):
            return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()[:12]

        def tensors(x):
            if isinstance(x, torch.Tensor):
                return [x]
            if isinstance(x, (list, tuple)):
                return [t for y in x for t in tensors(y)]
            return []

        def wrap(name):
            fn = getattr(megakernel, name)

            def inner(*a, **k):
                ins = tensors(list(a) + list(k.values()))
                key_in = [digest(x) for x in ins]
                saved = [x.clone() for x in ins] if dump else None
                out = fn(*a, **k)
                outs = tensors(out)
                trace.append((name, key_in, [digest(x) for x in outs], saved,
                              [x.clone() for x in outs] if dump else None))
                return out
            return inner

        for name in ("_raygen", "_tcap", "_closest_hit", "_shadow_blocked",
                     "_surfaces"):
            setattr(megakernel, name, wrap(name))

    pos, colors, radii, cam_kw, light = walk_scene()
    cfg = RenderConfig(aa_samples=2, ao_enabled=True, ao_samples=4,
                       shadows_enabled=True)
    res = {"threads": torch.get_num_threads()}
    for persp in (False, True):
        cam = CameraParams(**dict(cam_kw, is_perspective=persp))
        frame, bins, cd, lights, params = cs.prepare_sphere_frame(
            torch.device("cpu"), pos, colors, radii, cam, 320, 240, cfg,
            light_dir=light)
        kw = dict(S=3, tiles_x=bins.tiles_x, grid_n=32, eps=cfg.eps,
                  perspective=persp, shadows=True, n_peel=4)
        args = (cd, bins.sph_zmin, lights, params, 0)
        traces, outs = [], []
        for _ in range(3):
            trace.clear()
            outs.append(megakernel.mega_render_plain(*args, **kw))
            traces.append(list(trace))
        key = "perspective" if persp else "orthographic"
        pix = [int(((outs[a] - outs[b]).abs().view(-1, 3, 256).amax(1) > 0).sum())
               for a, b in PAIRS]
        res[key] = {"pixels": max(pix), "pairs 01 02 12": pix,
                    "max": max(float((outs[a] - outs[b]).abs().max()) for a, b in PAIRS)}
        keys = [[t[:3] for t in tr] for tr in traces]
        if with_hash and not keys[0] == keys[1] == keys[2]:
            first = next(i for i, calls in enumerate(zip(*keys))
                         if not calls[0] == calls[1] == calls[2])
            same_in = keys[0][first][1] == keys[1][first][1] == keys[2][first][1]
            res[key]["first_diff"] = [first, keys[0][first][0],
                                      "inputs equal" if same_in else "inputs differ"]
            if dump:
                os.makedirs(dump, exist_ok=True)
                torch.save([tr[first] for tr in traces],
                           os.path.join(dump, f"{key}_{os.getpid()}.pt"))
        if not np.isfinite(outs[0].numpy()).all():
            res[key]["finite"] = False
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--hash", action="store_true")
    ap.add_argument("--dump", default="")
    ap.add_argument("--child", action="store_true")
    opt = ap.parse_args()
    if opt.child:
        print(json.dumps(one_run(opt.threads, opt.hash, opt.dump)), flush=True)
        return
    cmd = [sys.executable, __file__, "--child", "--threads", str(opt.threads)]
    if opt.hash:
        cmd.append("--hash")
    if opt.dump:
        cmd += ["--dump", opt.dump]
    env = dict(os.environ, OMP_NUM_THREADS=str(opt.threads))
    runs = []
    for _ in range(opt.procs):
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, env=env)
        out = p.stdout.strip().splitlines()
        if p.returncode != 0 or not out:
            sys.exit(f"a run failed (exit {p.returncode})")
        runs.append(json.loads(out[-1]))
        print(out[-1], flush=True)
    bad = sum(any(r[k]["pixels"] for k in ("perspective", "orthographic"))
              for r in runs)
    print(json.dumps({"runs": len(runs), "runs_that_differ": bad,
                      "threads": opt.threads}))


if __name__ == "__main__":
    main()
