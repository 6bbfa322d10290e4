"""df64 (emulated float64) ES-DG Euler RHS: entropy acceptance from
f32 state arithmetic.

The reference attains machine-zero semi-discrete entropy residuals in
its native Float64 (rhstest, dg2D_euler_tri.jl:177-183).  The f32 RHS
carries genuine flux-level roundoff, so matching the acceptance without
native float64 requires evaluating the RHS itself in emulated f64
(where the device has float64, as the GPU does, a native float64 run
is the simpler check).  This module builds
a double-float (hi, lo f32 pair, ~2^-48 precision; utils.df64) variant
of the collocated Euler RHS:

  * entropy-variable map v(U) and inverse U(v) with df log/exp/pow,
  * logarithmic means with a wide-series branch (|f| < 1/4, 10 terms)
    so the exact branch never divides by a cancellation-limited
    difference of logs,
  * line-sparse volume flux differencing (the Kronecker structure of
    tensor_product_fd) with df accumulation,
  * compensated operator applications (df_apply — a matmul unit rounds
    every partial sum and cannot reach df accuracy),
  * the neighbor exchange rides the same exact data movement
    (rolls/gathers) on the (hi, lo) planes.

This is a VERIFICATION mode: expected ~10-100x the f32 cost, used to
certify entropy conservation / dissipation on the device, not to run
production steps.  The builder refuses a backend whose compiler breaks
the error-free transformations (utils.df64.require_exact_eft).

Scope: affine meshes, periodic (no BC hooks).  Collocated quad/hex
elements ride the line-sparse fd; modal (tri/simplex) elements the
dense q_skew operators with a scanned all-pairs loop — covering both
element families of the reference's entropy acceptance
(dg2D_euler_tri.jl and dg3D_euler_hex.jl).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.discretization import Discretization
from ..utils import df64 as D

# -----------------------------------------------------------------------------
# df constitutive maps (physics.euler in double-float)
# -----------------------------------------------------------------------------


def v_ufun_df(q, gamma):
    """q: tuple of Nf df pairs (rho, mom.., E) -> tuple of df entropy vars."""
    rho, mom, e = q[0], q[1:-1], q[-1]
    mom2 = None
    for m in mom:
        t = D.df_sqr(m)
        mom2 = t if mom2 is None else D.df_add(mom2, t)
    # p = (gamma-1) (E - mom2 / (2 rho))
    p = D.df_mul_c(
        D.df_sub(e, D.df_div(mom2, D.df_mul_f(rho, 2.0))), gamma - 1.0
    )
    s = D.df_sub(D.df_log(p), D.df_mul_c(D.df_log(rho), gamma))
    inv_p = D.df_recip(p)
    gm1 = gamma - 1.0
    # v1 = (gamma + 1 - s) - (gamma-1) E / p
    v1 = D.df_sub(
        D.df_add_c(D.df_neg(s), gamma + 1.0),
        D.df_mul_c(D.df_mul(e, inv_p), gm1),
    )
    vmom = tuple(D.df_mul_c(D.df_mul(m, inv_p), gm1) for m in mom)
    ve = D.df_mul_c(D.df_mul(rho, inv_p), -gm1)
    return (v1, *vmom, ve), p


def u_vfun_df(v, gamma):
    """Inverse entropy-variable map in df (physics.euler.u_vfun)."""
    v1, vmom, ve = v[0], v[1:-1], v[-1]
    dtype = v1[0].dtype
    vnorm = None
    for m in vmom:
        t = D.df_sqr(m)
        vnorm = t if vnorm is None else D.df_add(vnorm, t)
    neg_ve = D.df_neg(ve)
    # s = gamma - v1 + vnorm / (2 ve)
    s = D.df_add(
        D.df_add_c(D.df_neg(v1), gamma),
        D.df_neg(D.df_div(vnorm, D.df_mul_f(neg_ve, 2.0))),
    )
    gm1 = gamma - 1.0
    # rhoe = (gamma-1)^{1/(gamma-1)} * (-ve)^{-gamma/(gamma-1)}
    #        * exp(-s/(gamma-1))
    c = D.df_const(float(np.float64(gm1) ** (1.0 / gm1)), dtype)
    zero = jnp.zeros_like(v1[0])
    c = (c[0] + zero, c[1] + zero)
    rhoe = D.df_mul(
        D.df_mul(c, D.df_pow(neg_ve, -gamma / gm1)),
        D.df_exp(D.df_mul_c(s, -1.0 / gm1)),
    )
    rho = D.df_mul(rhoe, neg_ve)
    mom = tuple(D.df_mul(rhoe, m) for m in vmom)
    # e = rhoe * (1 - vnorm / (2 ve)) = rhoe * (1 + vnorm / (2 (-ve)))
    e = D.df_mul(
        rhoe, D.df_add_f(D.df_div(vnorm, D.df_mul_f(neg_ve, 2.0)), 1.0)
    )
    return (rho, *mom, e)


def logmean_df(a_l, a_r, log_l, log_r):
    """Double-float logarithmic mean.

    Series branch widened to |f| < 1/4 with 10 terms of
    D(v) = sum_k v^k / (4^k (2k+1)) (exact expansion of
    log((1+f/2)/(1-f/2)) / f in v = f^2), so the exact branch only runs
    where |log aR - log aL| >= ~0.25 and the df log difference keeps
    ~1e-13 relative accuracy.
    """
    da = D.df_sub(a_r, a_l)
    aavg = D.df_mul_f(D.df_add(a_l, a_r), 0.5)
    f = D.df_div(da, aavg)
    v = D.df_sqr(f)
    # Horner for D(v), k = 9..0 (scanned: graph-size discipline)
    coeffs = np.array([1.0 / (4.0**k * (2 * k + 1)) for k in range(9, -1, -1)])
    den = D.df_horner(v, coeffs)
    series = D.df_div(aavg, den)
    zero = jnp.zeros_like(a_l[0])

    use_series = jnp.abs(f[0]) < 0.25
    dlog = D.df_sub(log_r, log_l)
    safe_dlog = D.df_where(use_series, (jnp.ones_like(zero), zero), dlog)
    exact = D.df_div(da, safe_dlog)
    return D.df_where(use_series, series, exact)


def ec_flux_fields_df(ql, qr, logs_l, logs_r, gamma):
    """EC two-point flux on df field tuples (physics.euler.ec_flux_fields)."""
    rho_l, vel_l, beta_l = ql[0], ql[1:-1], ql[-1]
    rho_r, vel_r, beta_r = qr[0], qr[1:-1], qr[-1]
    dim = len(vel_l)

    rholog = logmean_df(rho_l, rho_r, logs_l[0], logs_r[0])
    betalog = logmean_df(beta_l, beta_r, logs_l[1], logs_r[1])

    rhoavg = D.df_mul_f(D.df_add(rho_l, rho_r), 0.5)
    velavg = [D.df_mul_f(D.df_add(a, b), 0.5) for a, b in zip(vel_l, vel_r)]
    vel_dot = None
    for a, b in zip(vel_l, vel_r):
        t = D.df_mul(a, b)
        vel_dot = t if vel_dot is None else D.df_add(vel_dot, t)
    pa = D.df_div(rhoavg, D.df_add(beta_l, beta_r))
    e_plus_p = D.df_add(
        D.df_add(
            D.df_div(rholog, D.df_mul_c(betalog, 2.0 * (gamma - 1.0))), pa
        ),
        D.df_mul_f(D.df_mul(rholog, vel_dot), 0.5),
    )

    fluxes = []
    for d in range(dim):
        f1 = D.df_mul(rholog, velavg[d])
        fmom = []
        for j in range(dim):
            t = D.df_mul(f1, velavg[j])
            fmom.append(D.df_add(t, pa) if j == d else t)
        fe = D.df_mul(e_plus_p, velavg[d])
        fluxes.append((f1, *fmom, fe))
    return tuple(fluxes)


# -----------------------------------------------------------------------------
# line-sparse volume flux differencing in df (affine, collocated)
# -----------------------------------------------------------------------------


def _lines_fd_df(qh, qlog, geo_df, gamma, *, elem_type, line_ops, nq):
    """df mirror of tensor_product_fd.flux_differencing_lines (affine).

    qh: tuple of Nf df pairs [Nh, K]; qlog: 2-tuple of df pairs;
    geo_df: list of dim*dim df pairs [1, K] (per-element scalars).
    Returns tuple of Nf df pairs [Nh, K] (the factor 2 applied).
    """
    from ..ops.tensor_product_fd import (
        _dir_layout,
        _face_table,
        _group_weights,
    )

    nf = len(qh)
    nh, k = qh[0][0].shape
    dim = 3 if elem_type == "hex" else 2
    n1d = line_ops.n1d
    nfp = (nh - nq) // (2 * dim)
    s1 = np.asarray(line_ops.s1)
    em = np.asarray(line_ops.e_minus)
    ep = np.asarray(line_ops.e_plus)
    w1 = np.asarray(line_ops.w1)
    faces = _face_table(elem_type, n1d, dim)
    dtype = qh[0][0].dtype
    zeros = lambda shape: (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

    acc_vol = [zeros((nq, k)) for _ in range(nf)]
    acc_face = [[None] * nf for _ in range(2 * dim)]

    def dfslice(a, rows):
        return a[0][rows[0]:rows[1], :], a[1][rows[0]:rows[1], :]

    def dfreshape(a, shape):
        return a[0].reshape(shape), a[1].reshape(shape)

    vol_fields = [dfslice(q, (0, nq)) for q in qh]
    vol_logs = [dfslice(l, (0, nq)) for l in qlog]

    for d in range(dim):
        shape, axis = _dir_layout(dim, n1d, d)
        vshape = (*shape, k)
        vol_d = [dfreshape(v, vshape) for v in vol_fields]
        logs_d = [dfreshape(l, vshape) for l in vol_logs]
        gw = _group_weights(dim, n1d, d, w1)[..., None]   # numpy f64

        geo_d = [
            dfreshape(geo_df[d * dim + x], (1,) * len(shape) + (k,))
            for x in range(dim)
        ]

        def contract(fluxes):
            out = []
            for f in range(nf):
                t = None
                for x in range(dim):
                    term = D.df_mul(geo_d[x], fluxes[x][f])
                    t = term if t is None else D.df_add(t, term)
                out.append(t)
            return out

        def line_index(a, j):
            sl = [slice(None)] * a[0].ndim
            sl[axis] = slice(j, j + 1)
            sl = tuple(sl)
            return a[0][sl], a[1][sl]

        def add_coeff(acc, coeff_np, fr):
            """acc [Nq,K] += (gw * coeff) * fr, coeff host f64."""
            c = np.asarray(gw * coeff_np, np.float64)
            c_df = D.df_split_array(c, dtype)
            t = D.df_mul((c_df[0], c_df[1]), fr)
            return D.df_add(acc, dfreshape(t, (nq, k)))

        # ---- volume-volume partners along the line: ONE scanned body
        # (an unrolled n1d-partner loop of df flux evaluations made the
        # traced graph big enough to stall XLA compiles) ----
        import jax as _jax

        cshape = [1] * len(shape)
        cshape[axis] = n1d
        cvol_np = np.stack([
            np.broadcast_to(
                np.asarray(gw * s1[:, ap].reshape(*cshape, 1), np.float64),
                (*shape, 1),
            ).reshape(nq)
            for ap in range(n1d)
        ])                                               # [n1d, Nq]
        cvol_df = D.df_split_array(cvol_np, dtype)

        vol_hi = jnp.stack([v[0] for v in vol_d])        # [Nf, *shape, K]
        vol_lo = jnp.stack([v[1] for v in vol_d])
        log_hi = jnp.stack([l[0] for l in logs_d])
        log_lo = jnp.stack([l[1] for l in logs_d])

        def vv_body(acc, inp):
            ap, ch, cl = inp

            def lslice(arr):
                return _jax.lax.dynamic_slice_in_dim(arr, ap, 1, axis + 1)

            vh, vl = lslice(vol_hi), lslice(vol_lo)
            lh, ll = lslice(log_hi), lslice(log_lo)
            qj = [(vh[f2], vl[f2]) for f2 in range(nf)]
            lj = [(lh[l2], ll[l2]) for l2 in range(2)]
            fluxes = ec_flux_fields_df(
                tuple(vol_d), tuple(qj), tuple(logs_d), tuple(lj), gamma
            )
            fr = contract(fluxes)
            new_acc = []
            for f2 in range(nf):
                t = D.df_mul(
                    (ch[:, None], cl[:, None]), dfreshape(fr[f2], (nq, k))
                )
                new_acc.append(D.df_add(acc[f2], t))
            return tuple(new_acc), None

        acc_vol, _ = _jax.lax.scan(
            vv_body, tuple(acc_vol),
            (jnp.arange(n1d), cvol_df[0], cvol_df[1]),
        )
        acc_vol = list(acc_vol)

        # ---- the two faces pierced by the line ----
        fid_m, fid_p, perm = faces[d]
        for fid, evec, sign in ((fid_m, em, -1.0), (fid_p, ep, +1.0)):
            rows = (nq + fid * nfp, nq + (fid + 1) * nfp)
            fvals = [dfslice(q, rows) for q in qh]
            flogs = [dfslice(l, rows) for l in qlog]
            if perm is not None:
                p = perm[0] if fid == fid_m else perm[1]
                fvals = [(v[0][p, :], v[1][p, :]) for v in fvals]
                flogs = [(l[0][p, :], l[1][p, :]) for l in flogs]
            fshape = list(shape)
            fshape[axis] = 1
            fvals = [dfreshape(v, (*fshape, k)) for v in fvals]
            flogs = [dfreshape(l, (*fshape, k)) for l in flogs]

            fluxes = ec_flux_fields_df(
                tuple(vol_d), tuple(fvals), tuple(logs_d), tuple(flogs), gamma
            )
            fr = contract(fluxes)
            cshape = [1] * len(shape)
            cshape[axis] = n1d
            coeff = (0.5 * sign) * evec.reshape(*cshape, 1)
            for f in range(nf):
                acc_vol[f] = add_coeff(acc_vol[f], coeff, fr[f])
                # face row: skew negative, reduced along the line
                c = np.asarray(gw * coeff, np.float64)
                c_df = D.df_split_array(c, dtype)
                t = D.df_mul((c_df[0], c_df[1]), fr[f])
                # df-accurate reduction along the line axis (a plain
                # f32 jnp.sum here cost 5e-8 relative on the fd output)
                def _sl(i):
                    idx = [slice(None)] * t[0].ndim
                    idx[axis] = i
                    return (t[0][tuple(idx)], t[1][tuple(idx)])

                contrib = _sl(0)
                for i in range(1, n1d):
                    contrib = D.df_add(contrib, _sl(i))
                contrib = D.df_neg(contrib)
                contrib = dfreshape(contrib, (nfp, k))
                if perm is not None:
                    p = perm[0] if fid == fid_m else perm[1]
                    inv = np.argsort(p)
                    contrib = (contrib[0][inv, :], contrib[1][inv, :])
                prev = acc_face[fid][f]
                acc_face[fid][f] = (
                    contrib if prev is None else D.df_add(prev, contrib)
                )

    out = []
    for f in range(nf):
        rows_hi = [acc_vol[f][0]]
        rows_lo = [acc_vol[f][1]]
        for i in range(2 * dim):
            af = acc_face[i][f]
            if af is None:
                af = zeros((nfp, k))
            rows_hi.append(af[0])
            rows_lo.append(af[1])
        out.append(
            D.df_mul_f(
                (jnp.concatenate(rows_hi, 0), jnp.concatenate(rows_lo, 0)),
                2.0,
            )
        )
    return tuple(out)


# -----------------------------------------------------------------------------
# the RHS
# -----------------------------------------------------------------------------


def _dense_fd_df(qh_st, qlog_st, geo_df, qskew_np, gamma, nf):
    """Dense all-pairs flux differencing in df for MODAL elements.

    qh_st / qlog_st: stacked df pairs [Nf, Nh, K] / [2, Nh, K];
    qskew_np: tuple of dim host-f64 [Nh, Nh] skew operators; geo_df:
    dim*dim df pairs [1, K].  Scanned over the partner index j (graph
    size O(1) in Nh); returns stacked df pair [Nf, Nh, K] incl. the
    factor 2.
    """
    import jax as _jax

    dim = len(qskew_np)
    nh = qh_st[0].shape[1]
    k = qh_st[0].shape[2]
    dtype = qh_st[0].dtype
    s_cols = [D.df_split_array(np.asarray(s, np.float64).T, dtype)
              for s in qskew_np]                        # [Nh(j), Nh(i)]

    qh_hi, qh_lo = qh_st
    ql_hi, ql_lo = qlog_st
    qi = tuple((qh_hi[f], qh_lo[f]) for f in range(nf))
    li = tuple((ql_hi[l], ql_lo[l]) for l in range(2))

    zero = jnp.zeros((nh, k), dtype)
    acc0 = tuple(
        tuple((zero, zero) for _ in range(nf)) for _ in range(dim * dim)
    )

    def body(acc, inp):
        j, cols_hi, cols_lo = inp
        qj = tuple(
            (_jax.lax.dynamic_slice_in_dim(qh_hi[f], j, 1, 0),
             _jax.lax.dynamic_slice_in_dim(qh_lo[f], j, 1, 0))
            for f in range(nf)
        )
        lj = tuple(
            (_jax.lax.dynamic_slice_in_dim(ql_hi[l], j, 1, 0),
             _jax.lax.dynamic_slice_in_dim(ql_lo[l], j, 1, 0))
            for l in range(2)
        )
        fluxes = ec_flux_fields_df(qi, qj, li, lj, gamma)
        new_acc = []
        for r in range(dim):
            c = (cols_hi[r][:, None], cols_lo[r][:, None])   # [Nh, 1]
            for d in range(dim):
                slot = r * dim + d
                row = []
                for f in range(nf):
                    t = D.df_mul(c, fluxes[d][f])
                    row.append(D.df_add(acc[slot][f], t))
                new_acc.append(tuple(row))
        return tuple(new_acc), None

    xs = (jnp.arange(nh),
          [s[0] for s in s_cols], [s[1] for s in s_cols])
    acc, _ = _jax.lax.scan(body, acc0, xs)

    # QF = 2 sum_d sum_r geo[r*dim+d] * acc[r,d]
    out = []
    for f in range(nf):
        t = None
        for r in range(dim):
            for d in range(dim):
                term = D.df_mul(geo_df[r * dim + d], acc[r * dim + d][f])
                t = term if t is None else D.df_add(t, term)
        out.append(D.df_mul_f(t, 2.0))
    return (jnp.stack([o[0] for o in out]), jnp.stack([o[1] for o in out]))


def make_euler_rhs_df64(
    disc: Discretization,
    host: dict,
    *,
    gamma: float = 1.4,
    dissipation: bool = False,
    compute_rhstest: bool = True,
):
    """Build the df64 verification RHS for an affine mesh.

    Collocated quad/hex elements use the line-sparse fd; modal
    (tri/simplex) elements use the dense q_skew operators with a
    scanned all-pairs loop — the full element family of the reference's
    entropy acceptance is covered.

    Args:
      disc: discretization (f32 leaves are fine; the accuracy-bearing
        operators come from ``host``).
      host: full-precision numpy arrays from
        ``build_discretization(..., return_host=True)``.

    Returns rhs(q, t=0.0) -> (dq_hi [Nf, Np, K] f32, aux) with aux:
      'rhstest' — the entropy-balance residual computed entirely in
      double-float (value returned as f32 hi+lo sum),
      'dq_lo' — the low parts (for accuracy tests against CPU f64).
    """
    if not disc.affine:
        raise ValueError("df64 RHS supports affine meshes")
    D.require_exact_eft("the df64 Euler RHS")
    collocated = disc.line_ops is not None

    nq, nh, np_ = disc.nq, disc.nh, disc.np_
    dim = disc.dim
    nf = dim + 2
    dtype = disc.wq.dtype

    split = lambda a: D.df_split_array(np.asarray(a, np.float64), dtype)
    ef_df = split(host["vhp"][nq:])          # [Nfq, Nq] face extrapolation
    vhp_df = split(host["vhp"])              # [Nh, Nq] (modal path)
    vq_op_df = split(host["vq"])             # [Nq, Np] (modal path)
    qskew_np = host["q_skew"]
    lift_df = split(host["lift"])            # [Np, Nfq]
    ph_df = split(host["ph"])                # [Np, Nh]
    vq_df = split(host["vq"])                # [Nq, Np]
    geo_np = np.asarray(host["geo"], np.float64)      # [dim*dim, 1, K]
    geo_df = [split(geo_np[i]) for i in range(geo_np.shape[0])]
    inv_jac_df = split(np.asarray(host["inv_jac"], np.float64)[:1])  # [1, K]
    wjq_df = split(host["wjq"])              # [Nq, K]
    nxj_df = [split(v) for v in host["nxj"]]
    sj_df = split(host["sj"])
    inv_sj_df = split(host["inv_sj"])

    def stack_df(fields):
        """tuple of df pairs [R, K] -> df pair [Nf, R, K]."""
        return (jnp.stack([f[0] for f in fields]),
                jnp.stack([f[1] for f in fields]))

    def unstack_df(a, n):
        return tuple((a[0][i], a[1][i]) for i in range(n))

    def rhs(q, t=0.0):
        del t
        q_df = tuple(D.df(q[f]) for f in range(nf))

        if collocated:
            # ---- entropy projection (collocated shortcut) ----
            vu, p_vol = v_ufun_df(q_df, gamma)
            vu_stacked = stack_df(vu)                   # [Nf, Nq, K]
            vuf = D.df_apply(ef_df, vu_stacked)         # [Nf, Nfq, K]
            uf = u_vfun_df(unstack_df(vuf, nf), gamma)

            # hybridized state: volume block is q itself
            uh = tuple(
                (jnp.concatenate([q_df[f][0], uf[f][0]], axis=0),
                 jnp.concatenate([q_df[f][1], uf[f][1]], axis=0))
                for f in range(nf)
            )
        else:
            # ---- modal entropy projection: Vq -> v(U) -> VhP -> U(v) --
            uq = D.df_apply(vq_op_df, stack_df(q_df))   # [Nf, Nq, K]
            vu, p_vol = v_ufun_df(unstack_df(uq, nf), gamma)
            vu_stacked = stack_df(vu)
            vuh = D.df_apply(vhp_df, vu_stacked)        # [Nf, Nh, K]
            uh = u_vfun_df(unstack_df(vuh, nf), gamma)

        # flux variables (rho, u.., beta) + logs at hybridized points
        rho_h, mom_h, e_h = uh[0], uh[1:-1], uh[-1]
        inv_rho = D.df_recip(rho_h)
        vel_h = tuple(D.df_mul(m, inv_rho) for m in mom_h)
        mom2 = None
        for m in mom_h:
            tt = D.df_sqr(m)
            mom2 = tt if mom2 is None else D.df_add(mom2, tt)
        p_h = D.df_mul_c(
            D.df_sub(e_h, D.df_div(mom2, D.df_mul_f(rho_h, 2.0))),
            gamma - 1.0,
        )
        beta_h = D.df_div(rho_h, D.df_mul_f(p_h, 2.0))
        qh = (rho_h, *vel_h, beta_h)
        qlog = (D.df_log(rho_h), D.df_log(beta_h))

        # ---- traces + one batched (hi|lo) neighbor exchange ----
        tr = lambda a: (a[0][nq:], a[1][nq:])
        qm = [tr(f) for f in qh]
        um = [tr(f) for f in uh]
        lm = [tr(l) for l in qlog]
        parts = qm + um + lm
        if dissipation:
            rhoun = None
            for d in range(dim):
                tt = D.df_mul(um[1 + d], nxj_df[d])
                rhoun = tt if rhoun is None else D.df_add(rhoun, tt)
            un = D.df_mul(D.df_mul(rhoun, inv_sj_df), D.df_recip(um[0]))
            pf = D.df_mul_c(
                D.df_sub(
                    um[-1],
                    D.df_mul_f(D.df_mul(um[0], D.df_sqr(un)), 0.5),
                ),
                gamma - 1.0,
            )
            c2 = D.df_mul_c(D.df_div(pf, um[0]), gamma)
            lam = D.df_add((jnp.abs(un[0]), jnp.sign(un[0]) * un[1]),
                           D.df_sqrt(c2))
            parts = parts + [lam]
        npart = len(parts)
        stacked_hi = jnp.stack([p[0] for p in parts])
        stacked_lo = jnp.stack([p[1] for p in parts])
        nbr = disc.gather_traces(
            jnp.concatenate([stacked_hi, stacked_lo], axis=0)
        )
        nbr_hi, nbr_lo = nbr[:npart], nbr[npart:]
        qp = [(nbr_hi[i], nbr_lo[i]) for i in range(nf)]
        up = [(nbr_hi[nf + i], nbr_lo[nf + i]) for i in range(nf)]
        lp = [(nbr_hi[2 * nf + i], nbr_lo[2 * nf + i]) for i in range(2)]

        # ---- EC surface flux (+ LF dissipation) ----
        fs = ec_flux_fields_df(tuple(qm), tuple(qp), tuple(lm), tuple(lp),
                               gamma)
        flux = []
        for f in range(nf):
            tt = None
            for d in range(dim):
                term = D.df_mul(fs[d][f], nxj_df[d])
                tt = term if tt is None else D.df_add(tt, term)
            flux.append(tt)
        if dissipation:
            lam_m = parts[-1]
            lam_p = (nbr_hi[npart - 1], nbr_lo[npart - 1])
            lam_max = D.df_where(lam_p[0] > lam_m[0], lam_p, lam_m)
            lfc = D.df_mul_f(D.df_mul(lam_max, sj_df), 0.25)
            for f in range(nf):
                flux[f] = D.df_sub(
                    flux[f], D.df_mul(lfc, D.df_sub(up[f], um[f]))
                )

        rhs_surf = D.df_apply(lift_df, stack_df(flux))   # [Nf, Np, K]

        # ---- volume flux differencing (line-sparse or dense, df) ----
        if collocated:
            qf = _lines_fd_df(
                [(f[0], f[1]) for f in qh],
                [(l[0], l[1]) for l in qlog],
                geo_df, gamma,
                elem_type=disc.elem_type, line_ops=disc.line_ops, nq=nq,
            )
            qf_st = stack_df(qf)
        else:
            qf_st = _dense_fd_df(
                stack_df(qh), stack_df(qlog), geo_df, qskew_np, gamma, nf
            )
        ph_qf = D.df_apply(ph_df, qf_st)                 # [Nf, Np, K]

        dq = D.df_mul(
            D.df_neg(D.df_add(ph_qf, rhs_surf)),
            (inv_jac_df[0][None], inv_jac_df[1][None]),
        )

        aux = {"dq_lo": dq[1]}
        if compute_rhstest:
            # rhstest = sum wJq * v * (Vq dq), all in df
            vq_dq = D.df_apply(vq_df, dq)
            prod = D.df_mul(
                D.df_mul((vu_stacked[0], vu_stacked[1]), vq_dq),
                (wjq_df[0][None], wjq_df[1][None]),
            )
            rt = D.df_sum_tree(prod)
            aux["rhstest"] = rt[0] + rt[1]
        return dq[0], aux

    return rhs
