"""Post-processing: plot-node interpolation and data dumps.

Parity with the reference's outputs: `Vp`-interpolated scatter fields
(dg2D_CNS_cavity_optimized.jl:1060-1069) and the text dumps consumed by
plot_cavity.m (xp/yp/thist/visc/squaredv/rhstesthist, :1071-1092).
Text and .npz writers are provided; plotting itself is left to the
user's environment (matplotlib optional).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def to_plot_nodes(ref_or_disc, fields):
    """Interpolate nodal fields [..., Np, K] to the plotting nodes."""
    vp = np.asarray(ref_or_disc.vp)
    out = [np.einsum("ij,...jk->...ik", vp, np.asarray(f)) for f in fields]
    return out if len(out) > 1 else out[0]


def plot_coordinates(disc):
    """Plot-node physical coordinates (requires vp on the object)."""
    return tuple(
        np.einsum("ij,jk->ik", np.asarray(disc.vp), np.asarray(c))
        for c in disc.x
    )


def write_text_dumps(directory: str, arrays: Dict[str, np.ndarray]):
    """One whitespace-delimited text file per array (plot_cavity.m
    format: xp.txt, yp.txt, thist.txt, ...)."""
    os.makedirs(directory, exist_ok=True)
    for name, arr in arrays.items():
        np.savetxt(os.path.join(directory, f"{name}.txt"), np.asarray(arr))


def write_npz(path: str, **arrays):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def extract_line(disc, fields, axis: int = 0, value: float = 0.0,
                 tol: float = 1e-10):
    """Sample nodal fields along a coordinate line through the domain.

    Interpolates to the equi-spaced plot nodes (exact basis evaluation,
    the reference's Vp machinery, dg2D_CNS_cavity_optimized.jl:1060-1069)
    and keeps the nodes with ``|x_axis - value| < tol``; duplicated
    points (element interfaces) are averaged.  On the uniform cavity
    meshes the centerlines x=0 / y=0 coincide with element boundaries
    and plot-node lines, so this is an exact trace of the DG solution.

    Returns (s, vals): s [M] the sorted coordinate(s) along the line
    (the remaining axis in 2D), vals [..., M] field values.
    """
    coords = plot_coordinates(disc)
    if len(coords) < 2:
        raise ValueError("extract_line needs a 2D/3D discretization "
                         "(a 1D solution already is a line)")
    fields = np.asarray(fields)
    fp = np.einsum("ij,...jk->...ik", np.asarray(disc.vp), fields)
    on_line = np.abs(coords[axis] - value) < tol
    if not on_line.any():
        raise ValueError(
            f"no plot nodes on the line x[{axis}] = {value}; "
            f"refine tol or pick a mesh line"
        )
    other_axes = [a for a in range(len(coords)) if a != axis]
    s = np.stack([coords[a][on_line] for a in other_axes], axis=-1)
    v = fp[..., on_line]
    # average duplicates (element-interface nodes appear once per side).
    # Gap-based clustering per axis: quantized rounding would split a
    # roundoff-separated pair straddling a grid-cell boundary.
    tol_ = max(tol, 1e-14)
    key = np.empty_like(s, dtype=np.int64)
    for d in range(s.shape[-1]):
        sv = np.sort(s[:, d])
        starts = sv[np.concatenate([[True], np.diff(sv) > tol_])]
        key[:, d] = np.searchsorted(starts, s[:, d], side="right") - 1
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    m = uniq.shape[0]
    counts = np.bincount(inv, minlength=m)
    s_out = np.zeros((m, s.shape[-1]))
    for d in range(s.shape[-1]):
        s_out[:, d] = np.bincount(inv, weights=s[:, d], minlength=m) / counts
    v_flat = v.reshape(-1, v.shape[-1])
    v_out = np.stack(
        [np.bincount(inv, weights=row, minlength=m) / counts
         for row in v_flat]
    ).reshape(*v.shape[:-1], m)
    order = np.lexsort(s_out.T[::-1])
    s_out = s_out[order]
    return (s_out[:, 0] if s_out.shape[1] == 1 else s_out), v_out[..., order]


def velocity_magnitude_squared(q):
    """(u^2 + v^2 [+ w^2]) from stacked conservative fields (the
    cavity driver's plotted observable, :1068)."""
    q = np.asarray(q)
    return sum((q[1 + d] / q[0]) ** 2 for d in range(q.shape[0] - 2))


def _reference_subcells(disc):
    """Subcell connectivity of one element's plot nodes.

    Uses element 0's physical plot coordinates: on every mesh here they
    are an affine image of the reference equi-spaced plot set, so their
    Delaunay topology is valid for all elements.  1D: consecutive
    segments (VTK_LINE); 2D: triangles (VTK_TRIANGLE); 3D: tetrahedra
    (VTK_TETRA).  Returns (cells [ncell, nverts], vtk_type).
    """
    pts = np.stack(
        [np.einsum("ij,j->i", np.asarray(disc.vp), np.asarray(c)[:, 0])
         for c in disc.x],
        axis=1,
    )
    if disc.dim == 1:
        order = np.argsort(pts[:, 0])
        return np.stack([order[:-1], order[1:]], axis=1), 3
    from scipy.spatial import Delaunay

    cells = Delaunay(pts).simplices
    if disc.dim == 2:
        a, b, c = (pts[cells[:, i]] for i in range(3))
        area = 0.5 * np.abs(
            (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
        )
        # relative sliver filter: robust to the mesh's physical scale
        return cells[area > 1e-9 * area.max()], 5
    a, b, c, d = (pts[cells[:, i]] for i in range(4))
    vol = np.abs(np.einsum(
        "ij,ij->i", b - a, np.cross(c - a, d - a))) / 6.0
    return cells[vol > 1e-9 * vol.max()], 10


def write_vtu(path: str, disc, fields: Dict[str, np.ndarray]):
    """Write a ParaView-readable VTK XML UnstructuredGrid (.vtu).

    Each field is a nodal array [Np, K]; fields are interpolated to the
    equi-spaced plot nodes and the elements are subdivided into linear
    VTK cells (segments / triangles / tetrahedra).  Plain-text XML, no
    external dependencies — the counterpart of the reference's
    MATLAB text dumps (plot_cavity.m).
    """
    vp = np.asarray(disc.vp)
    npp = vp.shape[0]
    k = disc.num_elements
    coords = [np.einsum("ij,jk->ik", vp, np.asarray(c)) for c in disc.x]
    while len(coords) < 3:
        coords.append(np.zeros_like(coords[0]))
    # element-major point layout: point id = e * npp + i
    pts = np.stack([c.T.reshape(-1) for c in coords], axis=1)  # [K*npp, 3]

    ref_cells, vtk_type = _reference_subcells(disc)
    ncell_ref, nverts = ref_cells.shape
    cells = (ref_cells[None, :, :] + (np.arange(k) * npp)[:, None, None])
    cells = cells.reshape(-1, nverts)

    data = {}
    for name, f in fields.items():
        fp = np.einsum("ij,jk->ik", vp, np.asarray(f))
        data[name] = fp.T.reshape(-1)

    npts, ncells = pts.shape[0], cells.shape[0]
    fmt = lambda a: "\n".join(
        " ".join(f"{v:.10g}" for v in row) for row in np.atleast_2d(a)
    )
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">',
        "<Points>",
        '<DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        fmt(pts),
        "</DataArray>",
        "</Points>",
        "<Cells>",
        '<DataArray type="Int64" Name="connectivity" format="ascii">',
        fmt(cells),
        "</DataArray>",
        '<DataArray type="Int64" Name="offsets" format="ascii">',
        fmt(np.arange(1, ncells + 1)[:, None] * nverts),
        "</DataArray>",
        '<DataArray type="UInt8" Name="types" format="ascii">',
        fmt(np.full((ncells, 1), vtk_type)),
        "</DataArray>",
        "</Cells>",
        "<PointData>",
    ]
    for name, arr in data.items():
        lines += [
            f'<DataArray type="Float64" Name="{name}" format="ascii">',
            fmt(arr[:, None]),
            "</DataArray>",
        ]
    lines += ["</PointData>", "</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path
