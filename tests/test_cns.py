"""CNS oracles, promoted from the reference driver checks (SURVEY.md 4):
Becker viscous-shocktube accuracy/convergence (dg1D_CNS_modalESDG), wall
BC entropy behavior on the cavity (dg2D_CNS_cavity_optimized), viscous
entropy production sign, and the adaptive DOPRI45 stepper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.presets import becker_shocktube_1d, lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import dopri45, ssprk33


def _shocktube_error(n, k, t_end=0.02):
    disc, q0, bc, shock = becker_shocktube_1d(n=n, k=k)
    # the 1D reference uses coefficient (2 mu - lambda_1d) with
    # lambda_1d = +2/3 mu, i.e. c2mu = 4/3 mu = 2 mu + lam with the
    # standard lam = -2/3 mu (the default).
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True)
    cn = (n + 1) * (n + 2) / 2
    dt = 2.0 / (cn * k * k)
    ns = int(np.ceil(t_end / dt))
    qf, _ = jax.jit(lambda q: ssprk33(rhs, q, t_end / ns, ns))(q0)
    # quadrature L2 error against the exact traveling wave
    uex = shock.conservative(np.asarray(disc.xq[0]), t_end)
    uq = jnp.einsum("ij,fjk->fik", disc.vq, qf)
    err = np.sqrt(np.sum(np.asarray(disc.wjq)[None] * (np.asarray(uq) - uex) ** 2))
    norm = np.sqrt(np.sum(np.asarray(disc.wjq)[None] * uex**2))
    return err / norm


def test_becker_shocktube_accuracy_and_convergence():
    e1 = _shocktube_error(3, 16)
    e2 = _shocktube_error(3, 32)
    assert e2 < 0.6 * e1, f"no convergence: {e1:.3e} -> {e2:.3e}"
    assert e2 < 2e-3, f"error too large: {e2:.3e}"


@pytest.mark.parametrize("bctype", ["adiabatic", "isothermal", "slip"])
def test_cavity_entropy_stability(bctype):
    """Real cavity solve: adaptive DOPRI45 to t = 0.1 (the reference's
    production loop, dg2D_CNS_cavity_optimized.jl:999-1053) in 5
    segments, asserting at every segment that the entropy balance
    rhstest <= 0 (entropy stability), the viscous entropy production
    sigma.grad(v) >= 0, and the state stays finite."""
    from esdg_cns_tpu.timestepping import dopri45

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, bctype=bctype)
    rhs = make_cns_rhs(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    )
    seg = 0.02
    dt0 = 2e-3
    step = jax.jit(lambda q: dopri45(rhs, q, seg, dt0, err_tol=1e-5))

    q = q0
    rhstests, viscs = [], []
    for _ in range(5):
        q, stats = step(q)
        assert float(stats["t"]) >= seg - 1e-12
        assert int(stats["n_accepted"]) >= 1
        assert np.isfinite(np.asarray(q)).all()
        rhstests.append(float(stats["rhstest"]))
        viscs.append(float(stats["rhstest_visc"]))
    assert all(v >= -1e-12 for v in viscs), viscs     # sigma . grad v >= 0
    assert all(r < 1e-10 for r in rhstests), rhstests  # no entropy produced
    if bctype != "slip":
        # a no-slip lid does nontrivial work by t=0.1: entropy decays
        assert min(rhstests) < -1e-8


def test_cavity_wall_no_slip_tendency():
    """With an adiabatic lid, the flow near the lid must accelerate in
    +x (the lid drags the fluid)."""
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, bctype="adiabatic")
    rhs = jax.jit(make_cns_rhs(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    ))
    dq, _ = rhs(q0)
    y = np.asarray(disc.x[1])
    near_lid = y > 0.9
    mom_x = np.asarray(dq[1])
    assert mom_x[near_lid].mean() > 0


def test_dopri45_adaptive():
    """Adaptive stepper integrates the shocktube and adapts dt."""
    disc, q0, bc, shock = becker_shocktube_1d(n=2, k=8)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True)
    t_end = 5e-3
    qf, stats = jax.jit(
        lambda q: dopri45(rhs, q, t_end, 1e-5, err_tol=1e-5)
    )(q0)
    assert float(stats["t"]) >= t_end - 1e-12
    assert int(stats["n_accepted"]) > 0
    assert np.isfinite(np.asarray(qf)).all()
    # dt should have grown from the conservative initial guess
    assert float(stats["dt"]) > 1e-5


def test_becker_shocktube_2d_accuracy():
    """2D extension of the Becker wave (periodic in y, Dirichlet in x)
    stays close to the exact 1D profile (dg2D_CNS_modalESDG parity)."""
    from esdg_cns_tpu.physics import BeckerShock
    from esdg_cns_tpu.presets import becker_shocktube_2d

    # mu=0.1 gives a shock thickness resolvable at this mesh size
    disc, q0, bc, shock = becker_shocktube_2d(n=2, k1d=12,
                                              shock=BeckerShock())
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    t_end = 0.01
    cn = 6.0
    dt = 2.0 / (cn * 12 * 12)
    ns = int(np.ceil(t_end / dt))
    qf, _ = jax.jit(lambda q: ssprk33(rhs, q, t_end / ns, ns))(q0)
    uq = np.asarray(jnp.einsum("ij,fjk->fik", disc.vq, qf))
    u1d = shock.conservative(np.asarray(disc.xq[0]).ravel(), t_end)
    w = np.asarray(disc.wjq)
    err = np.sqrt(np.sum(w * (uq[0] - u1d[0].reshape(uq[0].shape)) ** 2))
    norm = np.sqrt(np.sum(w * u1d[0].reshape(uq[0].shape) ** 2))
    assert err / norm < 0.05
    # transverse momentum stays ~0 (y-invariance of the wave)
    assert np.abs(uq[2]).max() < 1e-2


def test_dopri45_nan_bailout():
    """A NaN-producing RHS must terminate quickly with stalled=True and
    the last accepted (initial) state — not loop forever with a NaN dt
    (the failure mode of an under-resolved shock IC)."""
    from esdg_cns_tpu.timestepping import dopri45

    def bad_rhs(q, t=0.0):
        return jnp.full_like(q, jnp.nan), {}

    q0 = jnp.ones((2, 3, 4))
    qf, stats = jax.jit(
        lambda q: dopri45(bad_rhs, q, 1.0, 1e-2, max_stuck=10)
    )(q0)
    assert bool(stats["stalled"])
    assert float(stats["t"]) == 0.0
    assert int(stats["n_accepted"]) == 0
    np.testing.assert_array_equal(np.asarray(qf), np.asarray(q0))


def test_global_conservation():
    """Pin the comm-avoiding exchange's conservation behavior
    (docs/design.md known deviations): on a periodic mesh the
    domain integral of the RHS of every conservative field is zero up to
    roundoff (interface fluxes and LF penalties cancel to the round-trip
    precision of the flux-variable exchange), and multi-step LSRK45 mass
    and energy drift stays at accumulation-roundoff level.
    """
    from esdg_cns_tpu.core import build_discretization, ref_tri
    from esdg_cns_tpu.mesh import uniform_tri_mesh
    from esdg_cns_tpu.physics import primitive_to_conservative
    from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs
    from esdg_cns_tpu.timestepping import lsrk45

    vx, vy, etov = uniform_tri_mesh(6)
    disc = build_discretization(ref_tri(3), (vx, vy), etov,
                                periodic_axes=(0, 1))
    rng = np.random.default_rng(3)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(1.0 + 0.2 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(1.0 + 0.2 * rng.random(sh)),
    )

    def integrals(q):
        # domain integral per field: sum wJq * (Vq q)
        return jnp.einsum("jk,fjk->f", disc.wjq,
                          jnp.einsum("ij,fjk->fik", disc.vq, q))

    for rhs in (
        make_euler_rhs(disc, dissipation=True, compute_rhstest=False),
        make_cns_rhs_affine(disc, mu=1e-3, re=1e3,
                            inviscid_dissipation=True,
                            viscous_dissipation=False,
                            compute_rhstest=False),
    ):
        dq, _ = rhs(q0)
        tot = np.asarray(integrals(dq))
        scale = float(np.abs(np.asarray(dq)).max())
        assert np.abs(tot).max() < 1e-12 * scale, tot

        qf, _ = jax.jit(lambda q, r=rhs: lsrk45(r, q, jnp.float64(2e-4),
                                                20))(q0)
        drift = np.asarray(integrals(qf) - integrals(q0))
        ref = np.abs(np.asarray(integrals(q0)))
        assert np.abs(drift / ref).max() < 1e-12, drift / ref


def test_cavity_centerline_regression():
    """Reduced-scale pin of the flagship cavity's steady-field observable:
    N=2, K1D=4, Re=100 isothermal cavity to T=2 with
    adaptive DOPRI45 on the affine composed path; the x=0 / y=0
    centerline velocity profiles must reproduce the stored values (CPU
    f64 golden, generated by this exact configuration).
    """
    from esdg_cns_tpu.solvers import make_cns_rhs_affine
    from esdg_cns_tpu.utils.postprocess import extract_line

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, re=100.0)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=100.0, bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    )
    dt0 = min(0.5 * (2.0 / 4) / 6, 2.0 / (6 * 16))
    qf, stats = jax.jit(lambda q: dopri45(rhs, q, 2.0, dt0,
                                          err_tol=1e-6))(q0)
    assert float(stats["t"]) >= 2.0 - 1e-12

    u = np.asarray(qf[1] / qf[0])
    v = np.asarray(qf[2] / qf[0])
    y, uc = extract_line(disc, u[None], axis=0, value=0.0)
    x, vc = extract_line(disc, v[None], axis=1, value=0.0)
    idx = np.arange(0, y.size, 4)

    np.testing.assert_allclose(y[idx], np.linspace(-1, 1, 11), atol=1e-12)
    u_gold = [-0.02368981357, -0.0469839879, -0.05659925531,
              -0.06196945436, -0.07369860358, -0.08545117897,
              -0.1053649114, -0.1392816291, -0.1446466714,
              0.1864224123, 0.9197488177]
    v_gold = [0.002195448712, 0.04611858534, 0.05657179673,
              0.04214180958, 0.03029322641, 0.0103145664,
              -0.006771679671, -0.04301815598, -0.07679582962,
              -0.0582341967, 0.00117052678]
    np.testing.assert_allclose(uc[0][idx], u_gold, atol=5e-7)
    np.testing.assert_allclose(vc[0][idx], v_gold, atol=5e-7)


def test_grad_through_solver_re_sensitivity():
    """End-to-end differentiability — a capability the reference
    cannot express (its ForwardDiff use stops at per-step Jacobians):
    reverse-mode AD THROUGH the time loop (20 LSRK45 stages of the
    full CNS cavity RHS, wall BCs and viscous terms included) gives
    dJ/dRe of a kinetic-energy functional matching central finite
    differences to ~1e-5, and jax.checkpoint (rematerialization, the
    memory/recompute trade) leaves the gradient bit-compatible."""
    from esdg_cns_tpu.timestepping import lsrk45

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4)

    def ke_after(re, remat=False):
        rhs = make_cns_rhs(disc, mu=1.0 / re, pr=p["pr"], re=re, bc=bc,
                           inviscid_dissipation=True,
                           viscous_dissipation=True,
                           compute_rhstest=False)
        if remat:
            rhs = jax.checkpoint(rhs)
        qf, _ = lsrk45(rhs, q0, 5e-4, 20)
        uq = jnp.einsum("ij,fjk->fik", disc.vq, qf)
        return jnp.sum(disc.wjq * 0.5 * (uq[1] ** 2 + uq[2] ** 2) / uq[0])

    val, grad = jax.jit(jax.value_and_grad(ke_after))(1000.0)
    assert np.isfinite(float(val)) and float(val) > 0
    f = jax.jit(ke_after)
    h = 1.0
    fd = (float(f(1001.0)) - float(f(999.0))) / (2 * h)
    assert abs(float(grad) - fd) / abs(fd) < 1e-4, (float(grad), fd)

    grad_remat = jax.jit(jax.grad(lambda r: ke_after(r, True)))(1000.0)
    np.testing.assert_allclose(float(grad_remat), float(grad), rtol=1e-12)
