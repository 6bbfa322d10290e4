"""Line-sparse flux differencing for tensor-product (collocated) elements.

For Gauss-collocated quad/hex elements the hybridized skew operators are
Kronecker-sparse (the structure the reference exploits via sparse ids,
dg3D_euler_hex.jl:53-58 / dg2D_euler_quad.jl:62-64):

  * volume-volume couplings act only along 1D node lines:
    A_d[(..a..),(..a'..)] = (prod of other-dir weights) * S1[a, a'],
    with S1 = (W D - D' W)/2 from the 1D Gauss operators;
  * each volume node couples to exactly the two face nodes that its line
    pierces, with weights -+ 0.5 * wline * e(-+)[a];
  * face rows are the skew negatives; face-face couplings vanish.

So the O(Nh^2) all-pairs sum collapses to O(Nq * (n1d + 2)) two-point
fluxes per direction — a ~20x FLOP reduction at N=3 in 3D.  This module
implements the algorithm in pure JAX (works on any backend, autodiff
friendly); the per-direction partner loops are Python-unrolled into one
fused XLA computation.

All line constants are host-side numpy (compile-time constants).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..basis.jacobi import (
    gauss_quad,
    grad_vandermonde_1d,
    vandermonde_1d,
)
from ..physics.euler import ec_flux_fields


@dataclasses.dataclass(frozen=True)
class LineOps:
    """1D building blocks of the Kronecker structure (hashable: tuples)."""

    n1d: int
    s1: tuple        # [n1d][n1d]: (W D - D' W)/2
    e_minus: tuple   # interpolation to r = -1
    e_plus: tuple    # interpolation to r = +1
    w1: tuple        # Gauss weights

    @staticmethod
    def make(n: int, r1=None, w1=None) -> "LineOps":
        """Build from the collocated element's 1D rule (default Gauss;
        pass the LGL nodes/weights for the DG-SEM variant)."""
        if r1 is None:
            r1, w1 = gauss_quad(0, 0, n)
        r1, w1 = np.asarray(r1), np.asarray(w1)
        vinv = np.linalg.inv(vandermonde_1d(n, r1))
        d1 = grad_vandermonde_1d(n, r1) @ vinv
        s1 = 0.5 * (np.diag(w1) @ d1 - d1.T @ np.diag(w1))
        em = (vandermonde_1d(n, np.array([-1.0])) @ vinv).ravel()
        ep = (vandermonde_1d(n, np.array([1.0])) @ vinv).ravel()
        t = lambda a: tuple(map(tuple, a)) if a.ndim == 2 else tuple(a)
        return LineOps(n + 1, t(s1), t(em), t(ep), t(w1))


def _dir_layout(dim: int, n1d: int, d: int):
    """Volume reshape, line axis, group-weight shape and face info for
    direction d.

    Volume node flat index is a + n1d*b (+ n1d^2*c), a fastest.  Faces
    are ordered (r-,r+,s-,s+[,t-,t+]) for hex; (s-,r+,s+,r-) for quad
    is handled by the caller via the face table.
    """
    if dim == 3:
        shapes = {
            0: (n1d * n1d, n1d),   # (cb, a)
            1: (n1d, n1d, n1d),    # (c, b, a)
            2: (n1d, n1d * n1d),   # (c, ba)
        }
        axis = {0: 1, 1: 1, 2: 0}[d]
        return shapes[d], axis
    shapes = {0: (n1d, n1d), 1: (n1d, n1d)}  # (b, a)
    axis = {0: 1, 1: 0}[d]
    return shapes[d], axis


def _face_table(elem_type: str, n1d: int, dim: int):
    """(face_id_minus, face_id_plus, perm) per direction.

    perm maps the direction's group index to the face-node index (needed
    for the reference quad face ordering where top/left run reversed).
    """
    ident = np.arange(n1d)
    if elem_type == "hex":
        return {d: (2 * d, 2 * d + 1, None) for d in range(dim)}
    # quad faces: 0=bottom(s-), 1=right(r+), 2=top(s+), 3=left(r-)
    rev = ident[::-1]
    return {
        0: (3, 1, (rev, ident)),   # r-dir: left reversed, right identity
        1: (0, 2, (ident, rev)),   # s-dir: bottom identity, top reversed
    }


def _group_weights(dim: int, n1d: int, d: int, w1: np.ndarray):
    """w-product over non-line axes, shaped to broadcast over the volume
    reshape (without the trailing K axis)."""
    if dim == 3:
        if d == 0:
            return np.outer(w1, w1).reshape(n1d * n1d, 1)
        if d == 1:
            return (w1[:, None, None] * w1[None, None, :]).reshape(n1d, 1, n1d)
        return np.outer(w1, w1).reshape(1, n1d * n1d)
    return w1.reshape(n1d, 1) if d == 0 else w1.reshape(1, n1d)


def flux_differencing_lines(qh, qlog, geo, gamma, *, elem_type: str,
                            line_ops: LineOps, nq: int):
    """Line-sparse flux differencing for collocated quad/hex elements.

    Same contract as flux_differencing_xla: qh [Nf, Nh, K] flux variables,
    qlog [2, Nh, K], geo [dim*dim, Ng, K] (Ng = 1 affine, Nh curved);
    returns QF [Nf, Nh, K].
    """
    nf, nh, k = qh.shape
    dim = 3 if elem_type == "hex" else 2
    n1d = line_ops.n1d
    nfp = (nh - nq) // (2 * dim)
    # cast host-side f64 operator constants to the state dtype: numpy
    # f64 * jnp f32 promotes the whole accumulation to f64 when x64 is
    # enabled (the perm-form below casts at its jnp.asarray boundaries)
    s1 = np.asarray(line_ops.s1, dtype=qh.dtype)
    em = np.asarray(line_ops.e_minus, dtype=qh.dtype)
    ep = np.asarray(line_ops.e_plus, dtype=qh.dtype)
    w1 = np.asarray(line_ops.w1, dtype=qh.dtype)
    curved = geo.shape[1] != 1
    faces = _face_table(elem_type, n1d, dim)

    acc_vol = [jnp.zeros((nq, k), qh.dtype) for _ in range(nf)]
    acc_face = [[None] * nf for _ in range(2 * dim)]

    def fields_at(rows):
        return tuple(qh[f, rows[0]:rows[1], :] for f in range(nf))

    vol_fields = fields_at((0, nq))
    vol_logs = (qlog[0, :nq, :], qlog[1, :nq, :])

    for d in range(dim):
        shape, axis = _dir_layout(dim, n1d, d)
        vshape = (*shape, k)
        vol_d = [v.reshape(vshape) for v in vol_fields]
        logs_d = [l.reshape(vshape) for l in vol_logs]
        gw = _group_weights(dim, n1d, d, w1)[..., None]      # bcastable

        geo_d = []
        for x in range(dim):
            g = geo[d * dim + x]
            if curved:
                geo_d.append(g[:nq].reshape(vshape))
            else:
                geo_d.append(g.reshape((1,) * len(shape) + (k,)))

        def contract(fluxes, gj=None):
            """per-field geo-contracted flux: sum_x geo_avg[x]*F[x][f]."""
            out = []
            for f in range(nf):
                t = None
                for x in range(dim):
                    g = geo_d[x]
                    if curved and gj is not None:
                        g = 0.5 * (g + gj[x])
                    term = g * fluxes[x][f]
                    t = term if t is None else t + term
                out.append(t)
            return out

        def line_index(arr, j):
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(j, j + 1)
            return arr[tuple(sl)]

        # ---- volume-volume partners along the line ----
        for ap in range(n1d):
            qj = tuple(line_index(v, ap) for v in vol_d)
            lj = tuple(line_index(l, ap) for l in logs_d)
            fluxes = ec_flux_fields(vol_d, qj, logs_d, lj, gamma)
            gj = [line_index(g, ap) for g in geo_d] if curved else None
            fr = contract(fluxes, gj)
            # coeff[a, ap] along the line axis
            cshape = [1] * len(shape)
            cshape[axis] = n1d
            coeff = s1[:, ap].reshape(*cshape, 1)
            for f in range(nf):
                acc_vol[f] = acc_vol[f] + (gw * coeff * fr[f]).reshape(nq, k)

        # ---- the two faces pierced by the line ----
        fid_m, fid_p, perm = faces[d]
        for fid, evec, sign in ((fid_m, em, -1.0), (fid_p, ep, +1.0)):
            rows = (nq + fid * nfp, nq + (fid + 1) * nfp)
            fvals = fields_at(rows)
            flogs = (qlog[0, rows[0]:rows[1], :], qlog[1, rows[0]:rows[1], :])
            if perm is not None:
                p = perm[0] if fid == fid_m else perm[1]
                fvals = tuple(v[p, :] for v in fvals)
                flogs = tuple(l[p, :] for l in flogs)
            fshape = list(shape)
            fshape[axis] = 1
            fvals = tuple(v.reshape(*fshape, k) for v in fvals)
            flogs = tuple(l.reshape(*fshape, k) for l in flogs)

            fluxes = ec_flux_fields(vol_d, fvals, logs_d, flogs, gamma)
            if curved:
                gj = [
                    geo[d * dim + x, rows[0]:rows[1], :]
                    for x in range(dim)
                ]
                if perm is not None:
                    p = perm[0] if fid == fid_m else perm[1]
                    gj = [g[p, :] for g in gj]
                gj = [g.reshape(*fshape, k) for g in gj]
            else:
                gj = None
            fr = contract(fluxes, gj)

            cshape = [1] * len(shape)
            cshape[axis] = n1d
            coeff = (0.5 * sign) * evec.reshape(*cshape, 1)
            for f in range(nf):
                acc_vol[f] = acc_vol[f] + (gw * coeff * fr[f]).reshape(nq, k)
                # face row: skew negative, reduced along the line
                contrib = -jnp.sum(gw * coeff * fr[f], axis=axis)
                contrib = contrib.reshape(nfp, k)
                if perm is not None:
                    p = perm[0] if fid == fid_m else perm[1]
                    inv = np.argsort(p)
                    contrib = contrib[inv, :]
                prev = acc_face[fid][f]
                acc_face[fid][f] = contrib if prev is None else prev + contrib

    out_rows = []
    for f in range(nf):
        face_rows = [
            acc_face[i][f] if acc_face[i][f] is not None
            else jnp.zeros((nfp, k), qh.dtype)
            for i in range(2 * dim)
        ]
        out_rows.append(jnp.concatenate([acc_vol[f], *face_rows], axis=0))
    return 2.0 * jnp.stack(out_rows, axis=0)


def flux_differencing_lines_perm(qh, qlog, geo, gamma, *, elem_type: str,
                                 line_ops: LineOps, nq: int):
    """Line-sparse flux differencing in PERMUTATION form (flat layouts).

    Same contract and semantics as ``flux_differencing_lines``, but all
    arrays stay ``[Nq, K]`` / ``[Nfq, K]`` throughout: the along-line
    partner at offset ap is a static permutation gather of the node
    axis, the face partner is a static face->volume index map, and the
    skew-negative face-row reduction is one small 0/1-weighted GEMM per
    face.  No (n1, ...) axes or 1-extent line slices appear, so every
    step is an op on full-width flat arrays.
    """
    nf, nh, k = qh.shape
    dim = 3 if elem_type == "hex" else 2
    n1 = line_ops.n1d
    nfp = (nh - nq) // (2 * dim)
    s1 = np.asarray(line_ops.s1)
    em = np.asarray(line_ops.e_minus)
    ep = np.asarray(line_ops.e_plus)
    w1 = np.asarray(line_ops.w1)
    curved = geo.shape[1] != 1
    faces = _face_table(elem_type, n1, dim)
    dtype = qh.dtype

    idx = np.arange(nq)
    if dim == 3:
        coord = [idx % n1, (idx // n1) % n1, idx // (n1 * n1)]
    else:
        coord = [idx % n1, idx // n1]
    wq_np = w1[coord[0]]
    for c in coord[1:]:
        wq_np = wq_np * w1[c]

    vol = qh[:, :nq, :]
    vlog = qlog[:, :nq, :]
    vol_fields = tuple(vol[f] for f in range(nf))
    vol_logs = (vlog[0], vlog[1])

    acc = None
    face_outs = {}

    def contract(fluxes, geo_j_rows=None):
        """sum_x geo_avg[x] * F_x per field; geo_j_rows: partner rows of
        the hybridized-point geofacs for the curved average."""
        out = []
        for f in range(nf):
            t = None
            for x in range(dim):
                g = geo[cur_d * dim + x]
                if curved:
                    gi = g[:nq]
                    gj = geo_j_rows[x]
                    gg = 0.5 * (gi + gj)
                else:
                    gg = g
                term = gg * fluxes[x][f]
                t = term if t is None else t + term
            out.append(t)
        return out

    for cur_d in range(dim):
        a = coord[cur_d]
        wg = wq_np / w1[a]

        # ---- volume-volume partners: static node-axis permutation ----
        for ap in range(n1):
            perm = idx + (ap - a) * (n1 ** cur_d)      # coord[d] -> ap
            qj = tuple(vol[f, perm, :] for f in range(nf))
            lj = (vlog[0, perm, :], vlog[1, perm, :])
            fluxes = ec_flux_fields(vol_fields, qj, vol_logs, lj, gamma)
            gj = ([geo[cur_d * dim + x, :nq][perm] for x in range(dim)]
                  if curved else None)
            fr = contract(fluxes, gj)
            c = jnp.asarray((wg * s1[a, ap])[None, :, None], dtype)
            contrib = c * jnp.stack(fr)
            acc = contrib if acc is None else acc + contrib

        # ---- the two faces pierced by the line ----
        fid_m, fid_p, permf = faces[cur_d]
        # face-node id for each volume node: flatten the non-line coords
        # exactly like the reshape form does (reshape arange to fshape,
        # broadcast over the line axis)
        shape, axis = _dir_layout(dim, n1, cur_d)
        fshape = list(shape)
        fshape[axis] = 1
        fmap = np.broadcast_to(
            np.arange(nfp).reshape(fshape), shape
        ).reshape(nq)
        for fid, evec, sign in ((fid_m, em, -1.0), (fid_p, ep, +1.0)):
            if permf is not None:
                p = permf[0] if fid == fid_m else permf[1]
                fidx = p[fmap]                  # original face-node ids
            else:
                fidx = fmap
            rows = slice(nq + fid * nfp, nq + (fid + 1) * nfp)
            qface = qh[:, rows, :]
            lface = qlog[:, rows, :]
            qfv = tuple(qface[f, fidx, :] for f in range(nf))
            lfv = (lface[0, fidx, :], lface[1, fidx, :])
            fluxes = ec_flux_fields(vol_fields, qfv, vol_logs, lfv, gamma)
            gj = ([geo[cur_d * dim + x, rows][fidx] for x in range(dim)]
                  if curved else None)
            fr = contract(fluxes, gj)
            cvec = 0.5 * sign * wg * evec[a]           # [Nq] host
            c = jnp.asarray(cvec[None, :, None], dtype)
            wfr = c * jnp.stack(fr)
            acc = acc + wfr
            # skew-negative face rows: out[m] = -sum_{i: fidx[i]==m} wfr[i]
            # — a 0/1 [nfp, Nq] contraction, i.e. one small GEMM
            rmat = np.zeros((nfp, nq))
            rmat[fidx, idx] = 1.0
            contrib = -jnp.einsum(
                "mi,fik->fmk", jnp.asarray(rmat, dtype),
                wfr, precision=jax.lax.Precision.HIGHEST,
            )
            prev = face_outs.get(fid)
            face_outs[fid] = contrib if prev is None else prev + contrib

    parts = [acc] + [face_outs[i] for i in range(2 * dim)]
    return 2.0 * jnp.concatenate(parts, axis=1)


def flux_differencing_lines_rot(qh, qlog, geo, gamma, *, elem_type: str,
                                line_ops: LineOps, nq: int):
    """Line-sparse flux differencing with ROTATED layouts (affine hex).

    The reshape form's per-direction views place the line axis at
    different positions.  Here every direction is first rotated by one
    transpose so the line coordinate is the SLOWEST node axis: all flux
    evaluations then run on [.., n1, n1^2, K] views, the partner block
    is a contiguous leading-axis slice, and the face-row reduction is a
    plain leading-axis sum.  Semantics equal
    to flux_differencing_lines to roundoff (tested).

    Affine hex only (the benchmark family); falls back to
    flux_differencing_lines otherwise.
    """
    curved = geo.shape[1] != 1
    if elem_type != "hex" or curved:
        return flux_differencing_lines(qh, qlog, geo, gamma,
                                       elem_type=elem_type,
                                       line_ops=line_ops, nq=nq)
    nf, nh, k = qh.shape
    n1 = line_ops.n1d
    ng = n1 * n1
    nfp = (nh - nq) // 6
    s1 = np.asarray(line_ops.s1)
    em = np.asarray(line_ops.e_minus)
    ep = np.asarray(line_ops.e_plus)
    w1 = np.asarray(line_ops.w1)
    dtype = qh.dtype

    # node axes of the (c, b, a) view to put the line axis first;
    # groups then flatten in the same order as the reshape form's face
    # node ids ((c,b) / (c,a) / (b,a))
    axis_orders = {0: (2, 0, 1), 1: (1, 0, 2), 2: (0, 1, 2)}

    vol = qh[:, :nq].reshape(nf, n1, n1, n1, k)
    vlog = qlog[:, :nq].reshape(2, n1, n1, n1, k)

    acc = jnp.zeros((nf, nq, k), dtype)
    face_parts = {}

    for d in range(3):
        order = axis_orders[d]
        v_d = [vol[f].transpose([o for o in order] + [3]).reshape(n1, ng, k)
               for f in range(nf)]
        l_d = [vlog[l].transpose([o for o in order] + [3]).reshape(n1, ng, k)
               for l in range(2)]

        # host coeffs on the rotated index (a, g)
        # group weights: product of the two non-line 1D weights
        gw = np.outer(w1, w1).reshape(ng)          # order matches groups
        geo_d = [geo[d * 3 + x] for x in range(3)]  # [1, K] each

        def contract(fluxes):
            out = []
            for f in range(nf):
                t = None
                for x in range(3):
                    term = geo_d[x] * fluxes[x][f]
                    t = term if t is None else t + term
                out.append(t)
            return out

        acc_d = None
        for ap in range(n1):
            qj = tuple(v[ap:ap + 1] for v in v_d)          # [1, ng, K]
            lj = tuple(l[ap:ap + 1] for l in l_d)
            fluxes = ec_flux_fields(tuple(v_d), qj, tuple(l_d), lj, gamma)
            fr = contract(fluxes)                          # [n1, ng, K]
            c = jnp.asarray((s1[:, ap][:, None] * gw[None, :])[..., None],
                            dtype)
            contrib = jnp.stack([c * fr[f] for f in range(nf)])
            acc_d = contrib if acc_d is None else acc_d + contrib

        fid_m, fid_p = 2 * d, 2 * d + 1
        for fid, evec, sign in ((fid_m, em, -1.0), (fid_p, ep, +1.0)):
            rows = slice(nq + fid * nfp, nq + (fid + 1) * nfp)
            fv = tuple(qh[f, rows][None] for f in range(nf))   # [1, ng, K]
            fl = tuple(qlog[l, rows][None] for l in range(2))
            fluxes = ec_flux_fields(tuple(v_d), fv, tuple(l_d), fl, gamma)
            fr = contract(fluxes)
            c = jnp.asarray(
                (0.5 * sign * evec[:, None] * gw[None, :])[..., None], dtype
            )
            wfr = jnp.stack([c * fr[f] for f in range(nf)])
            acc_d = acc_d + wfr
            face_parts[fid] = -jnp.sum(wfr, axis=1)            # [nf, ng, K]

        # rotate the volume accumulator back to natural node order
        inv = np.argsort(order)
        acc_nat = acc_d.reshape(nf, n1, n1, n1, k).transpose(
            [0] + [1 + int(i) for i in inv] + [4]
        ).reshape(nf, nq, k)
        acc = acc + acc_nat

    parts = [acc] + [face_parts[i] for i in range(6)]
    return 2.0 * jnp.concatenate(parts, axis=1)
