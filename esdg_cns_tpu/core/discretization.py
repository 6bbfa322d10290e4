"""Device-resident discretization: operators + mesh arrays as one pytree.

Combines the roles of the reference's ``MeshData`` (src/SetupDG.jl:77-115,
init_mesh :275/:389) and the per-driver hybridized-operator packing
(e.g. dg2D_euler_tri.jl:70-77) into a single frozen pytree that jitted
RHS functions take as an argument.

Layout decisions:
  * element axis last everywhere: state [Nf, Np, K], traces [Nfq, K] —
    K is the vectorized and the sharded axis;
  * ``mapP`` is an int32 row-major flat index (node * K + elem) into the
    flattened [Nfq, K] trace array: one XLA gather, no scatter anywhere;
  * geometric factors are stored at the hybridized points, collapsed to a
    single per-element value when the mesh is affine (uniform meshes) so
    the flux-differencing kernel can use the cheap constant-geofac path;
  * 1/J and 1/(element size) style reciprocals are precomputed on host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..mesh.connectivity import build_node_maps, connect_mesh, make_periodic
from ..mesh.geometry import geometric_factors_2d, geometric_factors_3d
from ..utils.pytree import pytree_dataclass
from .ref_elem import RefElem

_META = (
    "elem_type", "n", "dim", "nfaces", "num_elements", "np_", "nq", "nfq",
    "nh", "affine", "periodic_axes", "line_ops", "grid_shape", "roll_plan",
)


@pytree_dataclass(meta_fields=_META)
class Discretization:
    # ---- static metadata ----
    elem_type: str
    n: int
    dim: int
    nfaces: int
    num_elements: int
    np_: int
    nq: int
    nfq: int
    nh: int
    affine: bool
    periodic_axes: tuple
    line_ops: object          # LineOps for collocated quad/hex, else None
    grid_shape: tuple         # (kz, ky, kx) for fully periodic uniform
                              # hex grids in generator order, else None
    roll_plan: tuple          # static half of the compiled roll exchange
                              # (ops.roll_exchange), else None

    # ---- reference operators (compute dtype) ----
    vq: jnp.ndarray          # [Nq, Np]
    vf: jnp.ndarray          # [Nfq, Np]
    pq: jnp.ndarray          # [Np, Nq]
    lift: jnp.ndarray        # [Np, Nfq]
    d: tuple                 # dim x [Np, Np]
    q_skew: tuple            # dim x [Nh, Nh]
    vh: jnp.ndarray          # [Nh, Np]
    ph: jnp.ndarray          # [Np, Nh]
    vhp: jnp.ndarray         # [Nh, Nq]
    wq: jnp.ndarray          # [Nq]
    wf: jnp.ndarray          # [Nfq]
    vp: jnp.ndarray          # [Nplot, Np] plotting interpolation

    # ---- mesh arrays ----
    x: tuple                 # dim x [Np, K] nodal coordinates
    xq: tuple                # dim x [Nq, K]
    xf: tuple                # dim x [Nfq, K]
    geo: jnp.ndarray         # [dim*dim, Ng, K]; Ng = 1 (affine) or Nh
    geo_nodal: jnp.ndarray   # [dim*dim, Ngn, K]; Ngn = 1 (affine) or Np
    jac: jnp.ndarray         # [Np, K]
    inv_jac: jnp.ndarray     # [Np, K]
    wjq: jnp.ndarray         # [Nq, K]
    nxj: tuple               # dim x [Nfq, K] scaled outward normals
    sj: jnp.ndarray          # [Nfq, K]
    inv_sj: jnp.ndarray      # [Nfq, K]
    map_p: jnp.ndarray       # int32 [Nfq, K] flat gather indices
    bmask: jnp.ndarray       # bool [Nfq, K] true on (non-periodic) boundary
    roll_masks: tuple        # data half of the compiled roll exchange

    def gather_traces(self, uf: jnp.ndarray) -> jnp.ndarray:
        """Neighbor values: uf may be [Nfq, K] or [Nf, Nfq, K].

        On fully periodic uniform hex grids (grid_shape set) the generic
        XLA gather is replaced by six rolls along the structured element
        axes — cheap static data movement.
        """
        if self.grid_shape is not None and self.elem_type == "hex":
            # flat-K rolls along the lane axis (never splitting it into
            # sub-axes, which forces expensive relayouts): a +-1 shift
            # along grid axis d is a flat roll by its stride, with the
            # periodic wrap fixed by blending in a second roll on the
            # wrap columns.
            import numpy as np

            kz, ky, kx = self.grid_shape
            k = self.num_elements
            idx = np.arange(k)
            xs, ys = idx % kx, (idx // kx) % ky
            zs = idx // (kx * ky)
            strides = (1, kx, kx * ky)
            periods = (kx, ky, kz)
            lowmask = (xs == 0, ys == 0, zs == 0)
            highmask = (xs == kx - 1, ys == ky - 1, zs == kz - 1)

            lead = uf.shape[:-2]
            nfp = self.nfq // 6
            v = uf.reshape(*lead, 6, nfp, k)
            fidx = len(lead)

            def take_face(i):
                sl = (slice(None),) * fidx + (i,)
                return v[sl]                    # [.., nfp, K]

            outs = []
            for d in range(3):
                s = strides[d]
                p = periods[d] * s
                lo = jnp.asarray(lowmask[d])
                hi = jnp.asarray(highmask[d])
                src_minus = take_face(2 * d + 1)   # opposite (+) face
                src_plus = take_face(2 * d)        # opposite (-) face
                outs.append(jnp.where(
                    lo, jnp.roll(src_minus, s - p, axis=-1),
                    jnp.roll(src_minus, s, axis=-1),
                ))
                outs.append(jnp.where(
                    hi, jnp.roll(src_plus, p - s, axis=-1),
                    jnp.roll(src_plus, -s, axis=-1),
                ))
            out = jnp.stack(outs, axis=fidx)
            return out.reshape(uf.shape)
        if self.roll_plan is not None:
            # compiled structured exchange: static lane rolls + masked
            # selects instead of a generic gather (ops.roll_exchange)
            from ..ops.roll_exchange import apply_roll_plan

            return apply_roll_plan(self.roll_plan, self.roll_masks, uf)
        flat = uf.reshape(*uf.shape[:-2], self.nfq * self.num_elements)
        return jnp.take(flat, self.map_p.reshape(-1), axis=-1).reshape(uf.shape)


def _to_dtype(x, dtype):
    return jnp.asarray(np.asarray(x), dtype=dtype)


def build_discretization(
    ref: RefElem,
    vertices: Sequence[np.ndarray],
    etov: np.ndarray,
    periodic_axes: tuple = (),
    curved_map=None,
    dtype: Optional[jnp.dtype] = None,
    grid_shape: Optional[tuple] = None,
    return_host: bool = False,
    geo_filters: Optional[tuple] = None,
) -> Discretization:
    """Assemble the full device-resident discretization.

    Args:
      ref: reference element from ``core.ref_elem``.
      vertices: dim arrays of vertex coordinates.
      etov: [K, nverts] element-to-vertex table.
      periodic_axes: axes along which the domain is periodic.
      curved_map: optional callable (x, y[, z]) -> same-shaped coords to
        curve the mesh after vertex interpolation (reference
        dg3D_euler_hex.jl:69-75 pattern).
      dtype: compute dtype (defaults to jnp default float).
      geo_filters: optional (Fr, Fs, Ft) [Np, Np] matrices filtering the
        curl-form metric construction (3D only; reference
        src/geometric_factors.jl:34,43 over-integration filters).
    """
    dtype = jnp.zeros(0).dtype if dtype is None else dtype
    dim = ref.dim
    k = etov.shape[0]
    if geo_filters is not None and dim != 3:
        raise ValueError("geo_filters is only meaningful for the 3D "
                         "curl-form metric construction")

    # nodal coordinates: x = V1 @ VX[EToV]^T   (SetupDG.jl:287)
    coords = [ref.v1 @ np.asarray(v)[etov].T for v in vertices]
    if curved_map is not None:
        coords = list(curved_map(*coords))

    xf_np = [ref.vf @ c for c in coords]
    xq_np = [ref.vq @ c for c in coords]

    # connectivity + node maps
    ftof = connect_mesh(etov, ref.face_vertices)
    nfp = ref.nfp
    _, map_p, _ = build_node_maps(xf_np, ftof, nfp)
    if periodic_axes:
        lengths = [np.asarray(v).max() - np.asarray(v).min() for v in vertices]
        map_p, ftof = make_periodic(
            xf_np, lengths, ftof, map_p, nfp, axes=periodic_axes
        )

    # geometric factors at solution nodes
    # geo_list is stored rdir-major: geo_list[rdir*dim + xdir] is the
    # metric factor pairing the rdir-direction operator with the
    # xdir-direction flux (d/dx_j = sum_r geo[r*dim+j] * D_r / J).
    if dim == 1:
        (dr,) = ref.d
        xr = dr @ coords[0]
        jac_np = xr
        geo_list = [np.ones_like(xr)]  # rxJ = rx * J = 1 in 1D
    elif dim == 2:
        rxj, sxj, ryj, syj, jac_np = geometric_factors_2d(*coords, *ref.d)
        geo_list = [rxj, ryj, sxj, syj]
    else:
        g = geometric_factors_3d(*coords, *ref.d, filters=geo_filters)
        rxj, sxj, txj, ryj, syj, tyj, rzj, szj, tzj = g[:9]
        jac_np = g[9]
        geo_list = [rxj, ryj, rzj, sxj, syj, szj, txj, tyj, tzj]

    if np.any(jac_np <= 0):
        raise ValueError("non-positive Jacobian: inverted element")

    # snap sub-roundoff metric entries to exact zero, AFFINE meshes
    # only: on axis-aligned meshes the off-diagonal geofacs (and
    # off-axis normal components below) are pure setup-matmul noise
    # (~1e-16 absolute from O(1) coordinates); zeroing them makes any
    # axis-aligned specialization that statically drops those terms
    # bit-consistent with the general contraction.  The curl-form noise
    # is RELATIVE to the coordinate scale, not the metric scale: geo
    # entries shrink like (1/k1d)^2 while the absolute noise stays
    # ~1e-15, so the relative noise grows with mesh refinement —
    # measured 6e-13 at k1d<=16 but 3.8e-11 at the k1d=32 bench mesh,
    # which silently defeated the old 1e-11 gate (round 5: the bench
    # ran the general contraction for this reason).  The gate is 1e-9
    # relative — still far below any legitimate affine metric entry
    # (that would need aspect ratio 1e9).  Curved meshes are NOT snapped:
    # a smooth nodal geofac may legitimately cross zero, and the
    # curl-form GCL is an exact nodal identity there that perturbation
    # would break; on affine metrics the GCL reduces to D_r applied to
    # per-element constants (exact for any constant), so the snap
    # cannot disturb it.
    def _snap(arrs):
        scale = max(np.abs(a).max() for a in arrs)
        return [np.where(np.abs(a) < 1e-9 * scale, 0.0, a) for a in arrs]

    g_stack = np.stack(geo_list)
    g_spread = np.abs(g_stack - g_stack.mean(axis=1, keepdims=True)).max()
    snap_ok = bool(g_spread < 1e-6 * max(np.abs(g_stack).max(), 1e-300))
    if snap_ok:
        geo_list = _snap(geo_list)

    # surface normals: nxJ = sum_r (Vf @ geo[r,x]) * nhat_r  (SetupDG.jl:312)
    nxj_np = []
    for xdir in range(dim):
        acc = np.zeros((ref.nfq, k))
        for rdir in range(dim):
            acc += (ref.vf @ geo_list[rdir * dim + xdir]) * ref.nrst_j[rdir][:, None]
        nxj_np.append(acc)
    if snap_ok:
        nxj_np = _snap(nxj_np)
    sj_np = np.sqrt(sum(v**2 for v in nxj_np))

    # interpolate geofacs to hybridized points; collapse if affine
    geo_h = np.stack([ref.vh @ g for g in geo_list], axis=0)  # [dim*dim, Nh, K]
    spread = np.abs(geo_h - geo_h.mean(axis=1, keepdims=True)).max()
    scale = max(np.abs(geo_h).max(), 1e-300)
    # the 3D curl-form construction carries O(eps) absolute roundoff from
    # O(1) coordinates, so the per-element spread of truly affine metrics
    # can reach ~1e-13 even when |geo| ~ h^2; use a loose relative gate
    affine = bool(spread < 1e-6 * scale)
    if affine:
        geo_h = geo_h.mean(axis=1, keepdims=True)  # [dim*dim, 1, K]
    geo_nodal = np.stack(geo_list, axis=0)         # [dim*dim, Np, K]
    if affine:
        geo_nodal = geo_nodal.mean(axis=1, keepdims=True)

    wjq_np = ref.wq[:, None] * (ref.vq @ jac_np)

    # convert mapP flat ids (node + Nfq*elem) -> row-major (node*K + elem)
    node = map_p % (ref.nfq)
    elem = map_p // (ref.nfq)
    map_p_rm = (node * k + elem).astype(np.int32)

    bmask_np = np.zeros((ref.nfq, k), dtype=bool)
    flat_self = (np.arange(ref.nfq)[:, None] * k + np.arange(k)[None, :]).astype(np.int32)
    bmask_np = map_p_rm == flat_self

    if grid_shape is not None:
        if ref.elem_type != "hex" or len(periodic_axes) != dim:
            raise ValueError("grid_shape needs a fully periodic hex mesh")
        if int(np.prod(grid_shape)) != k:
            raise ValueError("grid_shape does not match element count")

    # attempt the compiled roll exchange (structured grids); the fully
    # periodic hex fast path (grid_shape) takes precedence when set
    roll_plan, roll_masks = None, ()
    if grid_shape is None:
        from ..ops.roll_exchange import compile_roll_plan

        rolled = compile_roll_plan(map_p_rm, ref.nfp)
        if rolled is not None:
            roll_plan, masks_np = rolled
            roll_masks = tuple(
                tuple(jnp.asarray(m) for m in fm) for fm in masks_np
            )

    line_ops = None
    if ref.elem_type in ("quad", "hex") and ref.collocated:
        from ..ops.tensor_product_fd import LineOps

        # recover the 1D rule from the tensor structure (x fastest,
        # symmetric weights), so Gauss and LGL collocation both work
        n1 = ref.n + 1
        r1 = np.asarray(ref.rq[0])[:n1]
        w0 = float(np.asarray(ref.wq)[0]) ** (1.0 / dim)
        w1 = np.asarray(ref.wq)[:n1] / w0 ** (dim - 1)
        line_ops = LineOps.make(ref.n, r1, w1)

    host = None
    if return_host:
        # full-precision (numpy f64) copies of the operator/mesh arrays,
        # for consumers that need better-than-compute-dtype accuracy —
        # the df64 verification RHS (solvers.euler_df64) splits these
        # into double-float (hi, lo) pairs.  Not part of the pytree.
        host = {
            "vq": ref.vq, "vf": ref.vf, "pq": ref.pq, "lift": ref.lift,
            "d": tuple(ref.d), "q_skew": tuple(ref.q_skew),
            "vh": ref.vh, "ph": ref.ph, "vhp": ref.vhp,
            "wq": ref.wq, "wf": ref.wf,
            "geo": geo_h, "geo_nodal": geo_nodal,
            "jac": jac_np, "inv_jac": 1.0 / jac_np, "wjq": wjq_np,
            "nxj": tuple(nxj_np), "sj": sj_np, "inv_sj": 1.0 / sj_np,
        }

    f = lambda a: _to_dtype(a, dtype)
    disc_out = Discretization(
        elem_type=ref.elem_type, n=ref.n, dim=dim, nfaces=ref.nfaces,
        num_elements=k, np_=ref.np_, nq=ref.nq, nfq=ref.nfq, nh=ref.nh,
        affine=affine, periodic_axes=tuple(periodic_axes),
        line_ops=line_ops,
        grid_shape=tuple(grid_shape) if grid_shape is not None else None,
        vq=f(ref.vq), vf=f(ref.vf), pq=f(ref.pq), lift=f(ref.lift),
        d=tuple(f(di) for di in ref.d),
        q_skew=tuple(f(qi) for qi in ref.q_skew),
        vh=f(ref.vh), ph=f(ref.ph), vhp=f(ref.vhp),
        wq=f(ref.wq), wf=f(ref.wf), vp=f(ref.vp),
        x=tuple(f(c) for c in coords),
        xq=tuple(f(c) for c in xq_np),
        xf=tuple(f(c) for c in xf_np),
        geo=f(geo_h), geo_nodal=f(geo_nodal),
        jac=f(jac_np), inv_jac=f(1.0 / jac_np),
        wjq=f(wjq_np),
        nxj=tuple(f(v) for v in nxj_np),
        sj=f(sj_np), inv_sj=f(1.0 / sj_np),
        map_p=jnp.asarray(map_p_rm),
        bmask=jnp.asarray(bmask_np),
        roll_plan=roll_plan,
        roll_masks=roll_masks,
    )
    return (disc_out, host) if return_host else disc_out
