"""Interactive 3D visualization in Jupyter via k3d (optional dependency).

A host copy of ``mdapy_tpu/render/visualize.py`` (:1-239, whole; parity:
reference visualize.py, View class), over the port's ``core/elements.py``.
Requires ``k3d``; raises the JAX package's ImportError otherwise. For
offline/batch rendering use :class:`mdapy_tpu_torch.TachyonRender`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["View"]


def _require_k3d():
    try:
        import k3d
    except ImportError as err:  # pragma: no cover - optional dep
        raise ImportError(
            "View requires the optional dependency 'k3d' "
            "(https://k3d-jupyter.org). For offline rendering use "
            "mdapy_tpu.TachyonRender."
        ) from err
    return k3d


class View:
    """k3d scatter view of a System: atoms colored by element/type/field,
    box edges, colorbar label."""

    def __init__(self, system):
        _require_k3d()
        self.system = system
        self.label = None
        self.init_plot()

    def _box2lines(self) -> Tuple[np.ndarray, np.ndarray]:
        m = self.system.box.matrix
        o = self.system.box.origin
        corners = np.array([
            o, o + m[0], o + m[1], o + m[2], o + m[0] + m[1],
            o + m[0] + m[2], o + m[1] + m[2], o + m[0] + m[1] + m[2],
        ], dtype=np.float32)
        edges = np.array([
            [0, 1], [0, 2], [0, 3], [1, 4], [1, 5], [2, 4], [2, 6],
            [3, 5], [3, 6], [4, 7], [5, 7], [6, 7],
        ], dtype=np.uint32)
        return corners, edges

    def _radii(self) -> np.ndarray:
        from ..core.elements import display_radius_for_numbers, symbols_to_numbers

        data = self.system.data
        if "element" in data:
            nums = symbols_to_numbers(np.asarray(data["element"]).astype(str))
            return (display_radius_for_numbers(nums) / 2).astype(np.float32)
        return np.full(self.system.N, 0.6, dtype=np.float32)

    def _colors_by_element(self) -> np.ndarray:
        from ..core.elements import colors_for_numbers, symbols_to_numbers

        data = self.system.data
        if "element" in data:
            nums = symbols_to_numbers(np.asarray(data["element"]).astype(str))
            rgb = colors_for_numbers(nums)
        else:
            rgb = np.full((self.system.N, 3), 0.7)
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint32)
        return (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]

    def _colors_by_type(self) -> np.ndarray:
        from ..core.elements import colors_for_types

        types = np.asarray(self.system.data["type"], dtype=int)
        rgb = colors_for_types(types)
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint32)
        return (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]

    def init_plot(self) -> None:
        k3d = _require_k3d()
        self.plot = k3d.plot()
        verts, idx = self._box2lines()
        self.box = k3d.lines(verts, idx, indices_type="segment",
                             color=0x000000, width=0.1)
        self.atoms = k3d.points(
            self.system.pos.astype(np.float32),
            point_sizes=2 * self._radii(),
            colors=self._colors_by_element(),
            shader="mesh",
        )
        self.plot += self.box
        self.plot += self.atoms

    def colored_by_element(self) -> None:
        self.atoms.colors = self._colors_by_element()
        self._clear_label()

    def colored_by_type(self) -> None:
        self.atoms.colors = self._colors_by_type()
        self._clear_label()

    def colored_by(self, column: str, cmap: str = "viridis",
                   vmin: Optional[float] = None,
                   vmax: Optional[float] = None) -> None:
        """Color atoms by a per-atom scalar column with a colormap."""
        k3d = _require_k3d()
        import matplotlib.cm as cm

        vals = np.asarray(self.system.data[column], dtype=float)
        lo = vals.min() if vmin is None else vmin
        hi = vals.max() if vmax is None else vmax
        t = np.clip((vals - lo) / max(hi - lo, 1e-30), 0, 1)
        rgb = (np.array(cm.get_cmap(cmap)(t))[:, :3] * 255).astype(np.uint32)
        self.atoms.colors = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        self._clear_label()
        self.label = k3d.text2d(
            f"{column}: [{lo:.4g}, {hi:.4g}] ({cmap})",
            position=(0.01, 0.01), color=0x000000, size=0.8,
        )
        self.plot += self.label

    def _clear_label(self) -> None:
        if self.label is not None:
            self.plot -= self.label
            self.label = None

    # -- structure-type coloring (reference visualize.py:290-430) ---------
    _STRUCTURE_SCHEMES = {
        # column -> {value: (name, rgb hex)}
        "cna": {0: ("Other", 0xFFFFFF), 1: ("FCC", 0x66CC66),
                2: ("HCP", 0xCC6666), 3: ("BCC", 0x6666CC),
                4: ("ICO", 0xCCCC66)},
        "aja": {0: ("Other", 0xFFFFFF), 1: ("FCC", 0x66CC66),
                2: ("HCP", 0xCC6666), 3: ("BCC", 0x6666CC),
                4: ("ICO", 0xCCCC66)},
        "ptm": {0: ("Other", 0xFFFFFF), 1: ("FCC", 0x66CC66),
                2: ("HCP", 0xCC6666), 3: ("BCC", 0x6666CC),
                4: ("ICO", 0xCCCC66), 5: ("SC", 0xA0A0A0),
                6: ("CubicDiamond", 0x4CC9B0), 7: ("HexDiamond", 0xC98A4C),
                8: ("Graphene", 0x808080)},
        "ids": {0: ("Other", 0xFFFFFF), 1: ("CubicDia", 0x4CC9B0),
                2: ("CubicDia1NN", 0x36907E), 3: ("CubicDia2NN", 0x255F54),
                4: ("HexDia", 0xC98A4C), 5: ("HexDia1NN", 0x8F6236),
                6: ("HexDia2NN", 0x5F4124)},
    }

    def colored_by_structure_type(self, method: str = "cna",
                                  show_label: bool = True) -> None:
        """Categorical coloring for structure-identification columns
        (cna / ptm / aja / ids) with an on-plot legend."""
        k3d = _require_k3d()
        scheme = self._STRUCTURE_SCHEMES.get(method)
        if scheme is None:
            raise ValueError(
                f"method must be one of {sorted(self._STRUCTURE_SCHEMES)}"
            )
        vals = np.asarray(self.system.data[method], dtype=int)
        colors = np.full(len(vals), 0xFFFFFF, np.uint32)
        counts = {}
        for v, (name, col) in scheme.items():
            m = vals == v
            colors[m] = col
            if m.any():
                counts[name] = (int(m.sum()), col)
        self.atoms.colors = colors
        self._clear_label()
        if show_label:
            text = "\n".join(
                f"{name}: {cnt}" for name, (cnt, _) in counts.items()
            )
            self.label = k3d.text2d(text, position=(0.01, 0.01),
                                    color=0x000000, size=0.8)
            self.plot += self.label

    # -- bonds (reference visualize.py bond lines) ------------------------
    def draw_bonds(self, rc=None, max_neigh: int = 20, width: float = 0.15,
                   color: int = 0x707070) -> None:
        """Draw bond lines.  Uses ``system.bond`` if present, else calls
        ``system.create_bonds(rc)`` (rc defaults to vdW-based cutoffs)."""
        k3d = _require_k3d()
        sys_ = self.system
        bond = getattr(sys_, "bond", None)
        if bond is None:
            if rc is None:
                raise ValueError(
                    "no bonds on the system; pass rc to create them"
                )
            bond = sys_.create_bonds(rc, max_neigh=max_neigh)
        # split PBC-crossing bonds: draw only pairs whose direct segment is
        # the minimum image (others would streak across the box)
        pos = sys_.pos
        box = sys_.box
        d = pos[bond[:, 1]] - pos[bond[:, 0]]
        frac = d @ box.inverse_box
        direct = np.all(np.abs(frac) < 0.5, axis=1)
        bond = bond[direct]
        self.bonds = k3d.lines(
            pos.astype(np.float32), bond.astype(np.uint32),
            indices_type="segment", color=color, width=width,
            group="bonds",
        )
        self.plot += self.bonds

    def hide_object_by_group_name(self, name: str, remove: bool = False):
        """Hide (or remove) all plot objects in a k3d group."""
        for obj in list(self.plot.objects):
            if getattr(obj, "group", None) == name:
                if remove:
                    self.plot -= obj
                else:
                    obj.visible = False

    def colored_by_attribute(self, column: str, cmap=None,
                             vmin: Optional[float] = None,
                             vmax: Optional[float] = None) -> None:
        """Continuous coloring through k3d's attribute/color_map path —
        draws a real colorbar (vs the text label of colored_by)."""
        k3d = _require_k3d()
        vals = np.asarray(self.system.data[column], dtype=np.float32)
        lo = float(vals.min()) if vmin is None else float(vmin)
        hi = float(vals.max()) if vmax is None else float(vmax)
        if cmap is None:
            cmap = k3d.matplotlib_color_maps.Viridis
        self.atoms.attribute = vals
        self.atoms.color_map = cmap
        self.atoms.color_range = [lo, hi]
        self._clear_label()

    def delete_color_bar(self) -> None:
        self.atoms.attribute = []
        self.atoms.color_map = []

    def display(self):
        return self.plot.display()

    def close(self) -> None:
        self.plot.close()
