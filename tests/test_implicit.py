"""Implicit path: Newton-Krylov midpoint stepping of Burgers and Euler,
entropy conservation of the Burgers EC flux, and the Jacobian-analysis
utilities (reference implicit_euler_2D / implicit_burgers_2D /
time_fluxes oracles)."""

import jax
import jax.numpy as jnp
import numpy as np

from esdg_cns_tpu.core import build_discretization, ref_line, ref_tri
from esdg_cns_tpu.mesh import uniform_line_mesh, uniform_tri_mesh
from esdg_cns_tpu.ops.jacobians import (
    build_rhs_matrix,
    hadamard_jacobian,
    hadamard_sum,
)
from esdg_cns_tpu.physics import primitive_to_conservative
from esdg_cns_tpu.solvers import make_euler_rhs
from esdg_cns_tpu.solvers.burgers import burgers_ec_flux, make_burgers_rhs
from esdg_cns_tpu.timestepping.implicit import implicit_midpoint


def _tri_disc(k1d=3, n=2):
    vx, vy, etov = uniform_tri_mesh(k1d)
    return build_discretization(ref_tri(n), (vx, vy), etov, periodic_axes=(0, 1))


def test_burgers_entropy_conservation():
    disc = _tri_disc()
    rhs = jax.jit(make_burgers_rhs(disc, dissipation=False))
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((1, disc.np_, disc.num_elements)))
    _, aux = rhs(u)
    assert abs(float(aux["rhstest"])) < 1e-12


def test_implicit_midpoint_burgers():
    """Implicit midpoint conserves the quadratic entropy exactly for the
    EC flux (the midpoint rule is entropy-conservative for quadratic
    entropies) and Newton converges."""
    disc = _tri_disc(3, 2)
    rhs = make_burgers_rhs(disc, dissipation=False)
    u0 = 0.5 * jnp.sin(jnp.pi * disc.x[0])[None]
    uf, aux = jax.jit(lambda u: implicit_midpoint(rhs, u, 0.05, 4))(u0)

    def entropy(u):
        uq = jnp.einsum("ij,fjk->fik", disc.vq, u)
        return float(jnp.sum(disc.wjq[None] * uq * uq) / 2)

    assert int(aux["newton_iters"].max()) <= 10
    assert float(aux["newton_residual"].max()) < 1e-10
    np.testing.assert_allclose(entropy(uf), entropy(u0), rtol=1e-10)


def test_implicit_midpoint_euler():
    """One implicit midpoint step on 2D Euler: Newton converges and the
    result agrees with a small-dt explicit step."""
    disc = _tri_disc(2, 2)
    rhs = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    rhs_aux = lambda q, t=0.0: (rhs(q, t)[0], {})
    rng = np.random.default_rng(1)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.05 * rng.random(sh)),
        jnp.asarray(0.1 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.05 * rng.random(sh)),
    )
    dt = 1e-3
    qf, aux = jax.jit(lambda q: implicit_midpoint(rhs_aux, q, dt, 1))(q0)
    assert float(aux["newton_residual"].max()) < 1e-10
    # compare against explicit midpoint fixed-point (same scheme)
    dq0, _ = rhs(q0)
    q_explicit = q0 + dt * rhs(q0 + 0.5 * dt * dq0)[0]
    assert float(jnp.abs(qf - q_explicit).max()) < 1e-5


def test_hadamard_utilities():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((5, 5)))
    a = 0.5 * (a - a.T)
    q = jnp.asarray(np.random.default_rng(1).random((1, 5)) + 1.0)
    flux = lambda qi, qj: burgers_ec_flux(qi, qj)
    hs = hadamard_sum(a, flux, q)
    # manual reference
    want = np.zeros(5)
    for i in range(5):
        for j in range(5):
            want[i] += float(a[i, j]) * float(
                burgers_ec_flux(q[0, i], q[0, j])
            )
    np.testing.assert_allclose(np.asarray(hs[0]), want, rtol=1e-12)

    jac = hadamard_jacobian(a, flux, q)
    # finite-difference check of one column
    eps = 1e-6
    qp = q.at[0, 2].add(eps)
    fd = (hadamard_sum(a, flux, qp) - hs) / eps
    np.testing.assert_allclose(
        np.asarray(jac[0, :, 0, 2]), np.asarray(fd[0]), rtol=1e-5, atol=1e-8
    )


def test_build_rhs_matrix_matches_linear_operator():
    disc_1d = build_discretization(
        ref_line(2), *(lambda v, e: ((v,), e))(*uniform_line_mesh(3)),
        periodic_axes=(0,),
    )
    from esdg_cns_tpu.solvers.advection import make_advection_rhs

    rhs = make_advection_rhs(disc_1d, beta=(1.0,))
    shape = (disc_1d.np_, disc_1d.num_elements)
    mat = build_rhs_matrix(lambda u: rhs(u)[0], shape)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(shape))
    np.testing.assert_allclose(
        np.asarray(mat @ u.reshape(-1)),
        np.asarray(rhs(u)[0].reshape(-1)),
        atol=1e-11,
    )


def test_global_sbp_assembly_matches_euler_rhs():
    """The assembled global SBP matrices reproduce the production ES-DG
    RHS: with Qx = 2(Ax+Bx), Qy = 2(Ay+By), the global Hadamard sum of
    the EC flux over the hybridized state, projected by Ph and scaled by
    -1/J, equals make_euler_rhs (dissipation off) on a periodic mesh
    (reference usage: implicit_euler_2D.jl:68-79,175)."""
    from esdg_cns_tpu.ops.jacobians import assemble_global_sbp_2d
    from esdg_cns_tpu.physics import conservative_to_primitive_beta
    from esdg_cns_tpu.physics.euler import ec_flux
    from esdg_cns_tpu.solvers.euler import _apply, entropy_projection

    disc = _tri_disc(2, 2)
    k, nh = disc.num_elements, disc.nh
    ax, ay, bx, by, b = assemble_global_sbp_2d(disc)
    qx = jnp.asarray((2.0 * (ax + bx)).toarray())
    qy = jnp.asarray((2.0 * (ay + by)).toarray())

    rng = np.random.default_rng(1)
    sh = (disc.np_, k)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    _, uh = entropy_projection(disc, q, 1.4)
    u = jnp.asarray(np.transpose(np.asarray(uh), (0, 2, 1)).reshape(4, -1))

    def fdir(d):
        def f(ui, uj):
            qi = conservative_to_primitive_beta(ui)
            qj = conservative_to_primitive_beta(uj)
            return ec_flux(qi, qj)[d]
        return f

    r = hadamard_sum(qx, fdir(0), u) + hadamard_sum(qy, fdir(1), u)
    r = jnp.asarray(np.transpose(np.asarray(r).reshape(4, k, nh), (0, 2, 1)))
    dq = -_apply(disc.ph, r) * disc.inv_jac[None]

    dq_ref, _ = make_euler_rhs(disc, dissipation=False)(q)
    np.testing.assert_allclose(np.asarray(dq), np.asarray(dq_ref),
                               rtol=1e-11, atol=1e-11)


def test_global_sbp_skew_symmetry():
    """On a fully periodic mesh the assembled global operators are
    skew-symmetric (the discrete integration-by-parts that entropy
    conservation rests on), and B is symmetric nonnegative."""
    from esdg_cns_tpu.ops.jacobians import assemble_global_sbp_2d

    disc = _tri_disc(3, 2)
    ax, ay, bx, by, b = assemble_global_sbp_2d(disc)
    for qg in (ax + bx, ay + by):
        asym = abs((qg + qg.T)).max()
        assert asym < 1e-12, asym
    assert abs((b - b.T)).max() < 1e-12
    assert b.min() >= 0.0


def test_assembled_newton_matches_matrix_free():
    """Assembled-Jacobian Newton for the implicit midpoint step (the
    reference's path: global SBP matrices + hadamard_jacobian +
    banded_matrix_function dV/dU, dU/dV chain, implicit_euler_2D.jl:
    168-195) converges to the same state as the matrix-free
    Newton-Krylov implicit_midpoint."""
    import jax.numpy as jnp

    from esdg_cns_tpu.ops.jacobians import (
        assemble_global_sbp_2d,
        banded_matrix_function,
    )
    from esdg_cns_tpu.physics import conservative_to_primitive_beta
    from esdg_cns_tpu.physics import euler as phys
    from esdg_cns_tpu.physics.euler import ec_flux
    from esdg_cns_tpu.solvers.euler import _apply

    disc = _tri_disc(1, 1)   # K=2, N=1: small enough for dense jacfwd
    k, nh, nq, np_ = disc.num_elements, disc.nh, disc.nq, disc.np_

    ax, ay, bx, by, _ = assemble_global_sbp_2d(disc)
    qx = jnp.asarray((2.0 * (ax + bx)).toarray())
    qy = jnp.asarray((2.0 * (ay + by)).toarray())

    rng = np.random.default_rng(2)
    sh = (np_, k)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.2 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    rhs = make_euler_rhs(disc, dissipation=False)
    dt = 1e-3

    # --- matrix-free reference ---
    qf_mf, aux = jax.jit(
        lambda q: implicit_midpoint(lambda qq, t=0.0: rhs(qq, t), q, dt, 1,
                                    tol=1e-13)
    )(q0)
    assert float(aux["newton_residual"].max()) < 1e-12

    # --- assembled Jacobian of the RHS at a state (global dense) ---
    vq_g = np.kron(np.eye(k), np.asarray(disc.vq))      # [NqK, NpK]
    vhp_g = np.kron(np.eye(k), np.asarray(disc.vhp))    # [NhK, NqK]
    ph_g = np.kron(np.eye(k), np.asarray(disc.ph))      # [NpK, NhK]
    invj_g = np.transpose(np.asarray(disc.inv_jac)).reshape(-1)  # [NpK]

    def fdir(d):
        def f(ui, uj):
            return ec_flux(conservative_to_primitive_beta(ui),
                           conservative_to_primitive_beta(uj))[d]
        return f

    def flat_em(x):   # [Nf, nodes, K] -> element-major [Nf, K*nodes]
        return jnp.asarray(
            np.transpose(np.asarray(x), (0, 2, 1)).reshape(x.shape[0], -1)
        )

    def unflat_em(x, nodes):
        return jnp.asarray(
            np.transpose(np.asarray(x).reshape(-1, k, nodes), (0, 2, 1))
        )

    v_point = lambda u: phys.v_ufun(u[:, None], 1.4)[:, 0]
    u_point = lambda v: phys.u_vfun(v[:, None], 1.4)[:, 0]

    def rhs_jacobian(q):
        uq = _apply(disc.vq, q)
        vu = phys.v_ufun(uq, 1.4)
        vh = _apply(disc.vhp, vu)
        uh = phys.u_vfun(vh, 1.4)
        uh_f = flat_em(uh)
        jr = (hadamard_jacobian(qx, fdir(0), uh_f)
              + hadamard_jacobian(qy, fdir(1), uh_f))   # [4,NhK,4,NhK]
        dudv = banded_matrix_function(jax.jacfwd(u_point), flat_em(vh))
        dvdu = banded_matrix_function(jax.jacfwd(v_point), flat_em(uq))
        # chain: r(uh(vh(vu(uq(q)))))
        j1 = np.einsum("finh,nmh->fimh", np.asarray(jr), np.asarray(dudv))
        j2 = np.einsum("fimh,hq->fimq", j1, vhp_g)
        j3 = np.einsum("fimq,mgq->figq", j2, np.asarray(dvdu))
        j4 = np.einsum("figq,qp->figp", j3, vq_g)
        jrhs = -np.einsum("p,pi,figj->fpgj", invj_g, ph_g, j4)
        return jrhs                                      # [4,NpK,4,NpK]

    # --- assembled Newton on the midpoint residual ---
    nglob = 4 * np_ * k
    q_mid = q0
    for _ in range(6):
        dq_mid, _ = rhs(q_mid)
        res = flat_em(q_mid - q0 - 0.5 * dt * dq_mid)
        jrhs = rhs_jacobian(q_mid)
        jac = (np.eye(nglob)
               - 0.5 * dt * np.asarray(jrhs).reshape(nglob, nglob))
        delta = np.linalg.solve(jac, -np.asarray(res).reshape(nglob))
        q_mid = q_mid + unflat_em(delta.reshape(4, -1), np_)
        if np.abs(delta).max() < 1e-13:
            break
    assert np.abs(delta).max() < 1e-13, "assembled Newton did not converge"
    qf_asm = 2.0 * q_mid - q0

    np.testing.assert_allclose(np.asarray(qf_asm), np.asarray(qf_mf),
                               rtol=1e-10, atol=1e-10)


def test_global_sbp_periodic_self_neighbor():
    """A one-element-wide periodic direction makes elements their OWN
    neighbor through the wrap (elem_g == ee, node_g != aa): those face
    couplings are genuine and must be assembled, not dropped as
    boundary self-maps.  Oracle: the assembled Hadamard RHS still
    matches make_euler_rhs."""
    from esdg_cns_tpu.ops.jacobians import assemble_global_sbp_2d, hadamard_sum
    from esdg_cns_tpu.physics import conservative_to_primitive_beta
    from esdg_cns_tpu.physics.euler import ec_flux
    from esdg_cns_tpu.solvers.euler import _apply, entropy_projection

    from esdg_cns_tpu.core import ref_quad
    from esdg_cns_tpu.mesh import uniform_quad_mesh

    # one-element-wide x direction: each quad's left face wraps to its
    # own right face (tri cells never self-pair: the wrap partner is
    # always the cell's other triangle)
    vx, vy, etov = uniform_quad_mesh(1, 2)
    disc = build_discretization(ref_quad(2), (vx, vy), etov,
                                periodic_axes=(0, 1))
    k, nh = disc.num_elements, disc.nh
    ax, ay, bx, by, b = assemble_global_sbp_2d(disc)
    # wrap couplings exist: some off-diagonal within-element-block face
    # entries (row and col in the same element's face rows)
    qx = 2.0 * (ax + bx)
    assert abs((qx + qx.T)).max() < 1e-12      # global skew-symmetry
    qy = 2.0 * (ay + by)
    qx, qy = jnp.asarray(qx.toarray()), jnp.asarray(qy.toarray())

    rng = np.random.default_rng(2)
    sh = (disc.np_, k)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    _, uh = entropy_projection(disc, q, 1.4)
    u = jnp.asarray(np.transpose(np.asarray(uh), (0, 2, 1)).reshape(4, -1))

    def fdir(d):
        def f(ui, uj):
            return ec_flux(conservative_to_primitive_beta(ui),
                           conservative_to_primitive_beta(uj))[d]
        return f

    r = hadamard_sum(qx, fdir(0), u) + hadamard_sum(qy, fdir(1), u)
    r = jnp.asarray(np.transpose(np.asarray(r).reshape(4, k, nh), (0, 2, 1)))
    dq = -_apply(disc.ph, r) * disc.inv_jac[None]
    dq_ref, _ = make_euler_rhs(disc, dissipation=False)(q)
    np.testing.assert_allclose(np.asarray(dq), np.asarray(dq_ref),
                               rtol=1e-11, atol=1e-11)


def test_block_jacobi_preconditioner_stiff_dt():
    """At reference-comparable stiff dt (~12x the explicit CFL limit)
    with a constrained Krylov budget, the colored block-Jacobi
    preconditioner converges Newton to the residual tolerance where the
    unpreconditioned solve stalls — the robustness analogue of the
    reference's sparse direct solve (implicit_euler_2D.jl:188).
    Measured table in PARITY.md."""
    from esdg_cns_tpu.timestepping.implicit import element_coloring

    disc = _tri_disc(4, 2)
    rhs = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    colors = element_coloring(disc)
    assert colors.shape[0] == 2  # uniform tri mesh is bipartite
    rng = np.random.default_rng(1)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    dt = 0.5  # explicit heuristic for this config ~0.042
    run = lambda **kw: jax.jit(lambda q: implicit_midpoint(
        rhs, q, dt, 1, gmres_restart=10, gmres_maxiter=1, **kw))(q0)
    _, aux_plain = run()
    _, aux_bj = run(precond_rhs=rhs, precond_colors=colors)
    res_plain = float(aux_plain["newton_residual"][0])
    res_bj = float(aux_bj["newton_residual"][0])
    assert res_bj < 1e-10, res_bj                  # converged
    assert res_plain > 1e-10, res_plain            # plain stalls here
    assert int(aux_bj["newton_iters"][0]) <= int(aux_plain["newton_iters"][0])


def test_newton_reports_residual_norm_not_step():
    """The convergence report is the residual norm: a solve stopped by
    max_newton with a stalled GMRES must report a LARGE residual, not a
    small step size."""
    disc = _tri_disc(4, 2)
    rhs = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    rng = np.random.default_rng(1)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    # deliberately starved solver at stiff dt
    _, aux = jax.jit(lambda q: implicit_midpoint(
        rhs, q, 1.0, 1, gmres_restart=5, gmres_maxiter=1, max_newton=5))(q0)
    r = float(aux["newton_residual"][0])
    dq0, _ = rhs(q0)
    assert r > 1e-8 * float(jnp.abs(dq0).max())  # honestly unconverged


def test_implicit_midpoint_sharded_pjit():
    """Preconditioned implicit midpoint under pjit element sharding
    matches the single-device result."""
    import jax
    from jax.sharding import Mesh

    if jax.device_count() < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")
    from esdg_cns_tpu.parallel import shard_discretization
    from esdg_cns_tpu.timestepping.implicit import element_coloring

    disc = _tri_disc(4, 2)
    rhs = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    colors = element_coloring(disc)
    rng = np.random.default_rng(1)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    dt = 0.2
    step = lambda r: (lambda q: implicit_midpoint(
        r, q, dt, 2, precond_rhs=r, precond_colors=colors))
    qf_ref, aux_ref = jax.jit(step(rhs))(q0)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, q_s = shard_discretization(mesh, "e", disc, q0)
    rhs_s = make_euler_rhs(disc_s, dissipation=True, compute_rhstest=False)
    qf_s, aux_s = jax.jit(step(rhs_s))(q_s)
    np.testing.assert_allclose(np.asarray(qf_s), np.asarray(qf_ref),
                               rtol=1e-10, atol=1e-10)
    assert float(aux_s["newton_residual"].max()) < 1e-10


def test_implicit_midpoint_cns_cavity():
    """Implicit viscous stepping — beyond the reference (its implicit
    machinery covers Euler/Burgers only, implicit_euler_2D.jl; CNS is
    explicit-only there).  The matrix-free Newton-GMRES midpoint
    stepper composes with the full CNS RHS (wall BCs, BR1 viscous
    terms) unchanged: at dt ~ 5x the explicit parabolic limit, Newton
    converges to ~1e-13 in 2 iterations with the colored block-Jacobi
    preconditioner and every step stays entropy-stable (rhstest < 0,
    the lid does work) and finite."""
    from esdg_cns_tpu.presets import lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs
    from esdg_cns_tpu.timestepping.implicit import element_coloring

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4)
    rhs = make_cns_rhs(disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                       inviscid_dissipation=True, viscous_dissipation=True)
    dt = 5e-3
    qf, aux = jax.jit(lambda q: implicit_midpoint(
        rhs, q, dt, 3, precond_rhs=rhs,
        precond_colors=element_coloring(disc)))(q0)
    assert int(np.asarray(aux["newton_iters"]).max()) <= 4
    assert float(np.asarray(aux["newton_residual"]).max()) < 1e-10
    assert np.isfinite(np.asarray(qf)).all()
    r = np.asarray(aux["rhstest"])
    assert np.all(r < 0) and np.all(r > -1e-3)
