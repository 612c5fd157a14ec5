"""Special Quasirandom Structure generation (ATAT-mcsqs-style).

Parity: reference sqs.py + src/sqs.cpp — van de Walle trigonometric
cluster-function basis (CALPHAD 42 (2013) 13-18), image-aware cluster
enumeration (every periodic image direction is a distinct cluster instance),
canonical (non-decreasing) function tuples per (body, shell) channel, and
the ATAT mcsqs objective with the d1 perfect-match reward.

A host copy of ``mdapy_tpu/build/sqs.py`` (:1-422, whole): the basis
(``_trigo_basis`` :29), the image-aware pair list (``_image_neighbors``
:41), the shell bins, the cluster enumeration and ``SQS`` with ``compute``
and ``is_sqs``.  Cluster enumeration is vectorised numpy; the sequential
Metropolis swap chains run in the port's copy of the native C++ engine
(``mdapy_tpu_torch/native/sqs_engine.cpp``) with one OpenMP thread per
replica.  The result is the port's ``System``, on the input system's
device; ``is_sqs`` reads its Warren-Cowley parameters there.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SQS"]

_ATAT_TOL = 1e-3
_SHELL_TOL = 0.05


def _trigo_basis(m: int) -> np.ndarray:
    """van de Walle per-site basis phi[k][s], k = 0..m-2."""
    phi = np.zeros((m - 1, m))
    s = np.arange(m)
    for t in range(1, m // 2 + 1):
        phi[2 * t - 2] = -np.cos(2.0 * np.pi * t * s / m)
    for t in range(1, (m + 1) // 2):
        phi[2 * t - 1] = -np.sin(2.0 * np.pi * t * s / m)
    return phi


def _image_neighbors(pos: np.ndarray, box: np.ndarray, rc: float):
    """All (i, j, image-offset, distance) pairs with d <= rc, counting every
    periodic image direction separately (ATAT convention; reference
    sqs.py:_build_image_neighbors). Returns per-atom arrays."""
    N = len(pos)
    lens = np.linalg.norm(box, axis=1)
    nmax = [max(1, int(np.ceil(rc / l)) + 1) for l in lens]
    i_list, j_list, img_list, d_list = [], [], [], []
    for nx in range(-nmax[0], nmax[0] + 1):
        for ny in range(-nmax[1], nmax[1] + 1):
            for nz in range(-nmax[2], nmax[2] + 1):
                img = nx * box[0] + ny * box[1] + nz * box[2]
                delta = pos[None, :, :] + img[None, None, :] - pos[:, None, :]
                dist = np.linalg.norm(delta, axis=2)
                mask = dist <= rc + 1e-9
                if nx == 0 and ny == 0 and nz == 0:
                    np.fill_diagonal(mask, False)
                ii, jj = np.nonzero(mask)
                if len(ii):
                    i_list.append(ii)
                    j_list.append(jj)
                    img_list.append(np.broadcast_to(img, (len(ii), 3)))
                    d_list.append(dist[ii, jj])
    if not i_list:
        return [np.empty(0, int)] * N, [np.empty((0, 3))] * N, [np.empty(0)] * N
    ii = np.concatenate(i_list)
    jj = np.concatenate(j_list)
    imgs = np.concatenate(img_list)
    dd = np.concatenate(d_list)
    order = np.argsort(ii, kind="stable")
    ii, jj, imgs, dd = ii[order], jj[order], imgs[order], dd[order]
    splits = np.searchsorted(ii, np.arange(1, N))
    return (
        np.split(jj, splits),
        np.split(imgs, splits),
        np.split(dd, splits),
    )


class _ShellBins:
    """First-seen-order shell binning with tolerance (scalar or signature)."""

    def __init__(self):
        self.keys = []

    def bin(self, key) -> int:
        if np.isscalar(key):
            for k, ref in enumerate(self.keys):
                if abs(key - ref) < _SHELL_TOL:
                    return k
        else:
            for k, ref in enumerate(self.keys):
                if len(ref) == len(key) and all(
                    abs(a - b) < _SHELL_TOL for a, b in zip(key, ref)
                ):
                    return k
        self.keys.append(key)
        return len(self.keys) - 1

    @property
    def diameters(self):
        return [k if np.isscalar(k) else k[-1] for k in self.keys]


class SQS:
    """Generate a Special Quasirandom Structure from a random alloy template.

    Only species labels are reshuffled; positions and cell are untouched.
    See the reference docs for cutoff guidance (``cutoffs[2]`` just past the
    shell you want constrained; optional ``3``/``4`` add multi-body terms).
    """

    def __init__(
        self,
        system,
        cutoffs: Dict[int, float],
        n_replicas: int = 4,
        max_steps: int = 100000,
        T: float = 0.05,
        seed: int = 0,
    ):
        if 2 not in cutoffs:
            raise ValueError("cutoffs must include key 2 (pair cutoff in A)")
        for k in cutoffs:
            if k not in (2, 3, 4):
                raise ValueError(
                    f"only 2-, 3- and 4-body cutoffs are supported (got {k})"
                )
        self._sys_in = system
        self.cutoffs = dict(cutoffs)
        self.n_replicas = int(n_replicas)
        self.max_steps = int(max_steps)
        self.T = float(T)
        self.seed = int(seed)

        self.system = None
        self.objective: Optional[float] = None
        self.correlations: Optional[np.ndarray] = None
        self.channel_info: Optional[list] = None
        self._best_types: Optional[np.ndarray] = None
        self._species_labels = None
        self._delta: Optional[np.ndarray] = None

    # ------------------------------------------------------------- plumbing
    def _extract_types(self):
        data = self._sys_in.data
        if "element" in data:
            elems = np.asarray(data["element"]).astype(str)
            labels = sorted(set(elems.tolist()))
            lut = {e: i for i, e in enumerate(labels)}
            return (
                np.array([lut[e] for e in elems], dtype=np.int32),
                len(labels), labels, "element",
            )
        if "type" in data:
            t = np.asarray(data["type"], dtype=np.int32) - 1
            n = int(t.max()) + 1
            return t, n, list(range(n)), "type"
        raise ValueError("System must have an 'element' or 'type' column")

    def _enumerate_clusters(self):
        """Return (clusters, shells per body, global shell diameters)."""
        pos = self._sys_in.pos.astype(float)
        box = np.asarray(self._sys_in.box.matrix, dtype=float)
        rc_max = max(self.cutoffs.values())
        nb_j, nb_img, nb_d = _image_neighbors(pos, box, rc_max)
        N = len(pos)

        per_body = []  # (n_pts, clusters int array (M,n), shell ids (M,), diams)

        rc2 = float(self.cutoffs[2])
        bins2 = _ShellBins()
        cl2, sh2 = [], []
        for i in range(N):
            sel = nb_d[i] <= rc2 + 1e-9
            for jv, dv in zip(nb_j[i][sel], nb_d[i][sel]):
                sh2.append(bins2.bin(float(dv)))
                cl2.append((i, jv))
        per_body.append((2, np.array(cl2, dtype=np.int32).reshape(-1, 2),
                         np.array(sh2, dtype=np.int32), bins2.diameters))

        for n_pts in (3, 4):
            if n_pts not in self.cutoffs:
                continue
            rcn = float(self.cutoffs[n_pts])
            bins = _ShellBins()
            cls, shs = [], []
            for i in range(N):
                sel = nb_d[i] <= rcn + 1e-9
                js = nb_j[i][sel]
                ps = pos[js] + nb_img[i][sel]
                ds = nb_d[i][sel]
                k = len(js)
                if k < n_pts - 1:
                    continue
                # pairwise distances among i's neighbours
                pd = np.linalg.norm(ps[:, None, :] - ps[None, :, :], axis=2)
                within = pd <= rcn + 1e-9
                if n_pts == 3:
                    a_idx, b_idx = np.nonzero(np.triu(within, 1))
                    for a, b in zip(a_idx, b_idx):
                        sig = tuple(sorted((ds[a], ds[b], pd[a, b])))
                        shs.append(bins.bin(sig))
                        cls.append((i, js[a], js[b]))
                else:
                    triu = np.triu(within, 1)
                    for a in range(k):
                        bs = np.nonzero(triu[a])[0]
                        for bi_, b in enumerate(bs):
                            for c in bs[bi_ + 1:]:
                                if not within[b, c]:
                                    continue
                                sig = tuple(sorted((
                                    ds[a], ds[b], ds[c],
                                    pd[a, b], pd[a, c], pd[b, c],
                                )))
                                shs.append(bins.bin(sig))
                                cls.append((i, js[a], js[b], js[c]))
            per_body.append((n_pts, np.array(cls, dtype=np.int32).reshape(-1, n_pts),
                             np.array(shs, dtype=np.int32), bins.diameters))

        # map local shells to a global diameter list (first-seen, tol-merged)
        gbins = _ShellBins()
        global_maps = []
        for _, _, _, diams in per_body:
            global_maps.append([gbins.bin(float(d)) for d in diams])
        return per_body, [float(d) for d in gbins.diameters], global_maps

    def _build_engine(self):
        from ..native import load_library

        type_arr, m, labels, label_kind = self._extract_types()
        n_atoms = len(type_arr)
        conc = np.bincount(type_arr, minlength=m) / n_atoms
        phi = _trigo_basis(m)
        point_corr = phi @ conc  # <phi_k>
        n_func = m - 1

        per_body, all_diams, global_maps = self._enumerate_clusters()

        # channel table: for each (n_pts, local shell) block, canonical tuples
        ch_npts, ch_funcs, ch_target, ch_diam, ch_shell = [], [], [], [], []
        cl_atoms, cl_npts, cl_ch0, cl_nch = [], [], [], []
        block_start: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for (n_pts, clusters, shells, diams), gmap in zip(per_body, global_maps):
            ftuples = list(
                itertools.combinations_with_replacement(range(n_func), n_pts)
            )
            for local_s in sorted(set(shells.tolist())):
                c0 = len(ch_npts)
                block_start[(n_pts, local_s)] = (c0, len(ftuples))
                gd = all_diams[gmap[local_s]]
                for ft in ftuples:
                    ch_npts.append(n_pts)
                    ch_funcs.append(list(ft) + [0] * (4 - n_pts))
                    ch_target.append(float(np.prod(point_corr[list(ft)])))
                    ch_diam.append(gd)
                    ch_shell.append(gmap[local_s])
            for cl, s in zip(clusters, shells):
                c0, nfn = block_start[(n_pts, int(s))]
                cl_atoms.append(list(cl) + [-1] * (4 - n_pts))
                cl_npts.append(n_pts)
                cl_ch0.append(c0)
                cl_nch.append(nfn)

        nc = len(ch_npts)
        ncl = len(cl_atoms)
        ch_ninst = np.zeros(nc, dtype=np.int32)
        for c0, nfn, npts in zip(cl_ch0, cl_nch, cl_npts):
            ch_ninst[c0 : c0 + nfn] += 1
        ch_weight = np.ones(nc)  # decay 0 -> all shell weights 1

        lib = load_library("sqs_engine")
        lib.sqs_create.restype = ctypes.c_void_p
        lib.sqs_objective.restype = ctypes.c_double
        lib.sqs_run_mc.restype = ctypes.c_double

        eng = lib.sqs_create()
        i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
        f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)
        P = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        arrs = dict(
            phi=f64(phi),
            ch_npts=i32(ch_npts), ch_funcs=i32(ch_funcs), ch_ninst=i32(ch_ninst),
            ch_target=f64(ch_target), ch_diam=f64(ch_diam), ch_weight=f64(ch_weight),
            cl_atoms=i32(cl_atoms), cl_npts=i32(cl_npts),
            cl_ch0=i32(cl_ch0), cl_nch=i32(cl_nch),
        )
        lib.sqs_setup(
            ctypes.c_void_p(eng), n_atoms, m, P(arrs["phi"]),
            nc, P(arrs["ch_npts"]), P(arrs["ch_funcs"]), P(arrs["ch_ninst"]),
            P(arrs["ch_target"]), P(arrs["ch_diam"]), P(arrs["ch_weight"]),
            ncl, P(arrs["cl_atoms"]), P(arrs["cl_npts"]),
            P(arrs["cl_ch0"]), P(arrs["cl_nch"]),
            1, ctypes.c_double(_ATAT_TOL), ctypes.c_double(1.0),
            ctypes.c_double(1.0),
        )
        meta = dict(
            lib=lib, eng=eng, nc=nc, arrs=arrs, type_arr=type_arr,
            labels=labels, label_kind=label_kind, n_atoms=n_atoms,
            ch_npts=np.asarray(ch_npts), ch_shell=np.asarray(ch_shell),
            ch_funcs=np.asarray(ch_funcs), ch_ninst=ch_ninst,
            ch_target=np.asarray(ch_target), ch_diam=np.asarray(ch_diam),
            all_diams=all_diams,
        )
        return meta

    # ------------------------------------------------------------------ run
    def compute(self) -> "SQS":
        meta = self._build_engine()
        lib, eng, nc = meta["lib"], meta["eng"], meta["nc"]
        type_arr = meta["type_arr"]
        n_atoms = meta["n_atoms"]
        P = lambda a: a.ctypes.data_as(ctypes.c_void_p)

        types_c = np.ascontiguousarray(type_arr, dtype=np.int32)
        corr = np.zeros(nc)
        if self.max_steps <= 0:
            best_types = types_c.copy()
            lib.sqs_correlations(ctypes.c_void_p(eng), P(types_c), P(corr))
            best_obj = lib.sqs_objective(ctypes.c_void_p(eng), P(types_c))
        else:
            import os

            best_types = np.zeros(n_atoms, dtype=np.int32)
            nthreads = min(self.n_replicas, os.cpu_count() or 1)
            best_obj = lib.sqs_run_mc(
                ctypes.c_void_p(eng), P(types_c),
                ctypes.c_longlong(self.max_steps), ctypes.c_double(self.T),
                self.n_replicas, ctypes.c_ulonglong(self.seed), nthreads,
                P(best_types), P(corr),
            )
        delta = np.zeros(nc)
        lib.sqs_per_channel_delta(ctypes.c_void_p(eng), P(best_types), P(delta))
        self._delta = delta

        from ..core.system import System

        data = self._sys_in.data
        cols = {c: np.array(data[c], copy=True) for c in data.columns}
        cols["type"] = (best_types + 1).astype(np.int32)
        if meta["label_kind"] == "element":
            cols["element"] = np.array(
                [meta["labels"][t] for t in best_types], dtype=object
            )
        self.system = System(data=cols, box=self._sys_in.box,
                             device=getattr(self._sys_in, "device", "cuda"))
        self.objective = float(best_obj)
        self.correlations = corr
        self._best_types = best_types.astype(np.int64)
        self._species_labels = meta["labels"]

        infos = []
        for i in range(nc):
            npts = int(meta["ch_npts"][i])
            infos.append({
                "n_pts": npts,
                "shell": int(meta["ch_shell"][i]),
                "diameter": float(meta["ch_diam"][i]),
                "funcs": meta["ch_funcs"][i][:npts].tolist(),
                "n_instances": int(meta["ch_ninst"][i]),
                "target": float(meta["ch_target"][i]),
                "corr": float(corr[i]),
            })
        self.channel_info = infos
        lib.sqs_destroy(ctypes.c_void_p(eng))
        return self

    # ------------------------------------------------------------- verdict
    def is_sqs(self, tol: float = 0.03, verbose: bool = True):
        """Formal SQS verdict: max over channels of |pi - target| < tol.

        Warren-Cowley max|alpha| per pair shell is reported alongside as
        diagnostic info (not part of the verdict), matching ATAT mcsqs."""
        if self.system is None:
            raise RuntimeError("call compute() before is_sqs()")
        delta_all = self._delta
        max_delta = float(delta_all.max()) if len(delta_all) else 0.0
        absolute_pass = max_delta < tol

        pair_d = sorted({
            ci["diameter"] for ci in self.channel_info if ci["n_pts"] == 2
        })
        per_shell = []
        for s_idx, d_s in enumerate(pair_d):
            rc = d_s + _SHELL_TOL
            wcp = self.system.cal_warren_cowley_parameter(rc=rc)
            mat = np.asarray(wcp.wcp)
            mat_off = mat - np.diag(np.diag(mat))
            per_shell.append({
                "shell": f"NN{s_idx + 1}",
                "diameter": float(d_s),
                "rc": float(rc),
                "max_abs": float(np.max(np.abs(mat))),
                "max_off_diag": float(np.max(np.abs(mat_off))),
                "matrix": mat,
            })

        verdict = absolute_pass
        info = {
            "verdict": verdict,
            "absolute": {"pass": absolute_pass, "max_delta": max_delta, "tol": tol},
            "warren_cowley": {"tol": tol, "per_shell": per_shell},
        }
        if verbose:
            from collections import Counter

            bcount = Counter(ci["n_pts"] for ci in self.channel_info)
            body_str = "  ".join(
                f"{nm}={bcount.get(n, 0)}"
                for n, nm in [(2, "pair"), (3, "triplet"), (4, "quad")]
                if bcount.get(n, 0)
            )
            print(f"SQS verification ({self._sys_in.N} atoms)")
            print("-" * 60)
            print(f"correlations    : {len(self.channel_info)} channels  ({body_str})")
            print(f"objective       : {self.objective:.5f}")
            ok = "PASS" if absolute_pass else "FAIL"
            print(f"absolute residual   max|pi - target| = {max_delta:.4f}"
                  f"   tol={tol:.3f}   {ok}    <- decides verdict")
            for s in per_shell:
                print(f"WCP {s['shell']:>3s}  d={s['diameter']:.3f} A    "
                      f"max|alpha|={s['max_abs']:.4f}   tol={tol:.3f}   INFO")
            print(f"Verdict: {'SQS' if verdict else 'NOT YET'}")
        return verdict, info
