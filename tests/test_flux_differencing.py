"""Flux-differencing equivalence: the line-sparse paths used on
collocated hexes/quads must match the dense XLA all-pairs contraction to
machine precision, on both affine and curved-geofac meshes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.ops.flux_differencing import flux_differencing_xla
from esdg_cns_tpu.physics import betafun, primitive_to_conservative
from esdg_cns_tpu.solvers.euler import entropy_projection


def _qh_inputs(disc, seed=0):
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((disc.dim, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    _, uh = entropy_projection(disc, q, 1.4)
    qh = jnp.concatenate([uh[0][None], uh[1:-1] / uh[0], betafun(uh)[None]], axis=0)
    qlog = jnp.stack([jnp.log(qh[0]), jnp.log(qh[-1])])
    return qh, qlog


@pytest.mark.parametrize("curved", [False, True], ids=["affine", "curved"])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_lines_matches_dense_xla_hex(n, curved):
    """The line-sparse flux differencing (the hex production path) is
    the dense all-pairs contraction with the Kronecker-zero pairs
    skipped: equal to roundoff in f64 at every order, affine and
    curved (pointwise-averaged geofacs)."""
    from esdg_cns_tpu.ops.tensor_product_fd import flux_differencing_lines
    from esdg_cns_tpu.presets import euler_hex_3d

    disc, _ = euler_hex_3d(n=n, k1d=2, curved=curved)
    assert disc.affine is not curved
    qh, qlog = _qh_inputs(disc, seed=n)
    a = flux_differencing_xla(qh, qlog, disc.q_skew, disc.geo, 1.4)
    b = flux_differencing_lines(qh, qlog, disc.geo, 1.4, elem_type="hex",
                                line_ops=disc.line_ops, nq=disc.nq)
    scale = float(jnp.abs(a).max())
    np.testing.assert_allclose(np.asarray(b) / scale, np.asarray(a) / scale,
                               rtol=1e-12, atol=1e-12)


def test_snap_detect_contract():
    """The setup snap invariant: on an axis-aligned affine hex mesh the
    off-diagonal metric entries and the off-axis normal components are
    EXACT zeros, also at the bench-scale meshes (the curl-form setup
    noise is absolute, so its relative size grows as the metric shrinks
    with k1d; the snap gate is relative 1e-9).  Curved metrics are never
    snapped (their curl-form GCL is an exact nodal identity), so free
    stream is preserved there (tests/test_euler_rhs.py)."""
    from esdg_cns_tpu.presets import euler_hex_3d

    def off_axis_zero(disc):
        geo = np.asarray(disc.geo)
        nxj = np.stack([np.asarray(a) for a in disc.nxj])
        nfp = nxj.shape[1] // 6
        return (all(np.all(geo[d * 3 + x] == 0.0)
                    for d in range(3) for x in range(3) if x != d)
                and all(np.all(nxj[x, f * nfp:(f + 1) * nfp] == 0.0)
                        for f in range(6) for x in range(3) if x != f // 2))

    for n_, k1d_ in ((3, 2), (3, 32), (4, 24)):
        disc, _ = euler_hex_3d(n=n_, k1d=k1d_)
        assert off_axis_zero(disc), (n_, k1d_)

    disc_c, _ = euler_hex_3d(n=3, k1d=2, curved=True)
    assert not disc_c.affine
    assert not off_axis_zero(disc_c)


@pytest.mark.parametrize("impl", ["lines_perm", "lines_rot"])
@pytest.mark.parametrize("n", [2, 4])
def test_layout_variants_match_lines_hex(impl, n):
    """The permutation-form and rotated-layout flux differencing are
    algebraically the same operator as the reshape-form lines path on
    hex meshes."""
    from esdg_cns_tpu.presets import euler_hex_3d
    from esdg_cns_tpu.solvers import make_euler_rhs

    disc, q0 = euler_hex_3d(n=n, k1d=2)
    a, _ = jax.jit(make_euler_rhs(disc, dissipation=True,
                                  flux_diff_impl="lines",
                                  compute_rhstest=False))(q0)
    b, _ = jax.jit(make_euler_rhs(disc, dissipation=True,
                                  flux_diff_impl=impl,
                                  compute_rhstest=False))(q0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-12, atol=1e-12)


def test_lines_perm_matches_lines_curved_and_quad():
    """lines_perm also covers curved hex metrics (pointwise-averaged
    geofacs) and the reference quad face orderings."""
    from esdg_cns_tpu.core import build_discretization, ref_quad
    from esdg_cns_tpu.mesh import uniform_quad_mesh
    from esdg_cns_tpu.physics import primitive_to_conservative
    from esdg_cns_tpu.presets import euler_hex_3d
    from esdg_cns_tpu.solvers import make_euler_rhs

    disc, q0 = euler_hex_3d(n=2, k1d=2, curved=True)
    a, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q0)
    b, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines_perm",
                          compute_rhstest=False)(q0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-12, atol=1e-12)

    vx, vy, etov = uniform_quad_mesh(3)
    discq = build_discretization(ref_quad(3), (vx, vy), etov,
                                 periodic_axes=(0, 1))
    rng = np.random.default_rng(0)
    sh = (discq.np_, discq.num_elements)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    a, _ = make_euler_rhs(discq, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q)
    b, _ = make_euler_rhs(discq, dissipation=True,
                          flux_diff_impl="lines_perm",
                          compute_rhstest=False)(q)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-12, atol=1e-12)


def test_f32_state_stays_f32_under_x64():
    """Dtype-stability contract: with x64 enabled (the test default),
    an f32 state through the lines/xla RHS paths must produce an f32
    dq — host-side f64 operator constants must not promote the
    accumulation (regression: numpy f64 line-operator constants
    promoted the whole lines path, breaking f32 runs under lax.scan).
    Also covers the BeckerShock traceable BC path (np.float64 scalar
    properties must stay weak)."""
    from esdg_cns_tpu.presets import becker_shocktube_1d, euler_hex_3d
    from esdg_cns_tpu.solvers import make_cns_rhs, make_euler_rhs

    disc, q0 = euler_hex_3d(n=1, k1d=2, dtype=jnp.float32)
    assert q0.dtype == jnp.float32
    for impl in ("xla", "lines", "lines_perm"):
        rhs = make_euler_rhs(disc, dissipation=True, flux_diff_impl=impl,
                             compute_rhstest=False)
        dq, _ = rhs(q0, 0.0)
        assert dq.dtype == jnp.float32, impl

    disc1, q1, bc, shock = becker_shocktube_1d(n=2, k=8,
                                               dtype=jnp.float32)
    rhs = make_cns_rhs(disc1, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    dq, _ = rhs(q1, 0.5)  # t>0 exercises the time-dependent exact BC
    assert dq.dtype == jnp.float32
