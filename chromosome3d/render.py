"""Model visualization.

The reference ships an `output_models/image.png` (and *_zoom.pdb files)
produced by out-of-repo tooling. This module renders CA-bead chain models
as 3D line plots colored by genomic position, so a run's best models can be
inspected without external viewers.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def render_model(
    coords: np.ndarray,
    out_png: str,
    title: Optional[str] = None,
    dpi: int = 120,
) -> str:
    """Render one (L, 3) chain to a PNG (3D projection, position-colored)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "rendering needs matplotlib, which is not installed; the solve "
            "and its PDB/text artifacts do not"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    coords = np.asarray(coords, dtype=float)
    L = len(coords)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    segs = np.stack([coords[:-1], coords[1:]], axis=1)
    lc = Line3DCollection(segs, cmap="viridis", linewidths=2.0)
    lc.set_array(np.arange(L - 1))
    ax.add_collection3d(lc)
    pad = 0.05 * np.ptp(coords, axis=0).max()
    for dim, setter in enumerate((ax.set_xlim, ax.set_ylim, ax.set_zlim)):
        setter(coords[:, dim].min() - pad, coords[:, dim].max() + pad)
    ax.set_box_aspect(np.ptp(coords, axis=0) + 1e-6)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.colorbar(lc, ax=ax, shrink=0.6, label="bead index (genomic position)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=dpi)
    plt.close(fig)
    return out_png


def render_run(out_dir: str, max_models: int = 1) -> Sequence[str]:
    """Render the top rank PDB(s) of a pipeline/genome output directory to
    <out_dir>/image.png (plus imageNN.png for extras)."""
    from chromosome3d.io.pdb import read_ca_pdb

    ranks = sorted(p for p in os.listdir(out_dir) if "_rank" in p and p.endswith(".pdb"))
    outs = []
    for k, name in enumerate(ranks[:max_models], start=1):
        png = os.path.join(out_dir, "image.png" if k == 1 else f"image{k:02d}.png")
        coords = read_ca_pdb(os.path.join(out_dir, name))
        outs.append(render_model(coords, png, title=name.replace(".pdb", "")))
    return outs
