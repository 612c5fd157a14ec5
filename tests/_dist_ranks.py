"""Spawned gloo worlds for the port's scale-out tests
(``tests/test_torch_distributed.py``).

This module imports torch, numpy and ``mdapy_tpu_torch`` only, never jax:
its ``_rank`` is the function each spawned rank runs, so no JAX runtime is
started in a rank.  ``run_world`` spawns ``world`` ranks that meet in a
``FileStore`` under a directory of the caller's (so that pytest workers
never share a port), runs the port's sharded routes on a ``make_mesh`` or
``make_hier_mesh`` of the requested shape on the CPU, and returns every
rank's results.
"""

import os
import pickle

import numpy as np
import torch


def _port_mega_inputs(m):
    """The port's megakernel arguments from the numpy copies of the JAX
    package's acceleration structures."""
    from mdapy_tpu_torch.render import megakernel as tmega
    from mdapy_tpu_torch.render.convert import (
        light_records_from_numpy, screen_bins_from_numpy,
    )

    bins = screen_bins_from_numpy(m["sph_chunks"], m["sph_zmin"], m["tiles_x"],
                                  m["tiles_y"], device="cpu")
    lights = tmega.stack_lights(
        m["params"], *light_records_from_numpy(*m["lrec"], device="cpu"),
        grid_n=m["grid_n"])
    chunk_data = torch.tensor(m["chunk_data"])
    kw = dict(S=1, width=m["W"], height=m["H"], tiles_x=m["tiles_x"],
              tiles_y=m["tiles_y"], grid_n=m["grid_n"], eps=m["eps"],
              perspective=m["perspective"], shadows=True)
    return chunk_data, bins, lights, kw


def _port_scene(t):
    from mdapy_tpu_torch.render.scene import build_scene

    return build_scene(t["pos"], t["colors"], t["radii"],
                       dtype=getattr(torch, t.get("dtype", "float64")),
                       device="cpu")


def _rank(rank, world, shape, inputs, store_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mdapy_tpu_torch.render import distributed as tdist
    from mdapy_tpu_torch.render import multihost as thost
    from mdapy_tpu_torch.render.config import RenderConfig

    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {"position": None}
        if len(shape) == 1:
            mesh = tdist.make_mesh(shape[0], device="cpu")
            mega = tdist.render_image_mega_sharded
        else:
            mesh = thost.make_hier_mesh(*shape, device="cpu")
            mega = thost.render_image_mega_hier
        out["position"] = tdist.mesh_position(mesh)
        m = inputs["mega"]
        if m.get("jax_sphere_hit"):
            from _jax_geometry import jax_sphere_hit

            jax_sphere_hit()
        chunk_data, bins, lights, kw = _port_mega_inputs(m)
        out["mega"] = mega(chunk_data, bins.sph_zmin, lights, m["params"], 0,
                           mesh=mesh, **kw).numpy()
        t = inputs["tracer"]
        scene = _port_scene(t)
        out["forward"] = tdist.render_image_sharded(
            scene, t["frame"], RenderConfig(**t["cfg"]), t["W"], t["H"], mesh,
            seed=t["seed"], chunk=t["chunk"]).numpy()
        g = inputs["grad"]
        gscene = _port_scene(g)
        steps = {}
        if len(shape) == 1:
            steps["flat"] = tdist.render_train_step(
                gscene, g["frame"], g["target"], RenderConfig(**g["cfg"]),
                g["W"], g["H"], mesh, chunk=g["chunk"])
        else:
            for k in g["remat"]:
                steps[f"hier{k}"] = thost.render_train_step_hier(
                    gscene, g["frame"], g["target"], RenderConfig(**g["cfg"]),
                    g["W"], g["H"], mesh, chunk=g["chunk"], remat_chunks=k)
        out["steps"] = {k: (float(loss), [x.numpy() for x in grads])
                        for k, (loss, grads) in steps.items()}
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run_world(world, shape, inputs, store_dir):
    """Spawn ``world`` ranks on a mesh of ``shape`` ((n,) flat or (hosts,
    cores)); returns each rank's results, in rank order."""
    import torch.multiprocessing as tmp

    os.makedirs(store_dir, exist_ok=True)
    tmp.start_processes(_rank, args=(world, tuple(shape), inputs, store_dir),
                        nprocs=world, join=True, start_method="spawn")
    out = []
    for rank in range(world):
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out
