"""Multi-device equivalence on the virtual 8-device CPU mesh:
pjit/SPMD element sharding and the explicit shard_map + ppermute halo
exchange must both reproduce the single-device RHS bitwise (or to f64
roundoff), and the psum'd diagnostics must match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from esdg_cns_tpu.core import build_discretization, ref_hex, ref_tri
from esdg_cns_tpu.mesh import uniform_hex_mesh, uniform_tri_mesh
from esdg_cns_tpu.parallel import (
    build_halo_exchange,
    make_sharded_euler_rhs,
    shard_discretization,
)
from esdg_cns_tpu.physics import primitive_to_conservative
from esdg_cns_tpu.solvers import make_euler_rhs
from esdg_cns_tpu.timestepping import lsrk45

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def _tri_setup(k1d=8, n=2):
    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov, periodic_axes=(0, 1))
    rng = np.random.default_rng(0)
    sh = (disc.np_, disc.num_elements)
    q = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    return disc, q


def test_pjit_spmd_equivalence():
    disc, q = _tri_setup()
    ref_rhs = jax.jit(make_euler_rhs(disc, dissipation=True))
    dq_ref, aux_ref = ref_rhs(q)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, q_s = shard_discretization(mesh, "e", disc, q)
    dq_s, aux_s = jax.jit(make_euler_rhs(disc_s, dissipation=True))(q_s)
    np.testing.assert_allclose(
        np.asarray(dq_s), np.asarray(dq_ref), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        float(aux_s["rhstest"]), float(aux_ref["rhstest"]), atol=1e-10
    )


def test_shard_map_halo_equivalence():
    disc, q = _tri_setup()
    ref_rhs = jax.jit(make_euler_rhs(disc, dissipation=True))
    dq_ref, aux_ref = ref_rhs(q)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    rhs_sm = jax.jit(make_sharded_euler_rhs(mesh, disc, dissipation=True))
    dq_sm, aux_sm = rhs_sm(q)
    np.testing.assert_allclose(
        np.asarray(dq_sm), np.asarray(dq_ref), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        float(aux_sm["rhstest"]), float(aux_ref["rhstest"]), atol=1e-10
    )


def test_halo_round_trip():
    """Halo gather of face coordinates returns coincident coordinates
    (shard-consistency check, SURVEY.md section 5 race-detection row)."""
    disc, _ = _tri_setup()
    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    halo = build_halo_exchange(disc, 8)
    from esdg_cns_tpu.parallel.sharding import partition_specs
    from jax import shard_map

    specs = partition_specs(halo, disc.num_elements, "e")

    f = shard_map(
        lambda xf, h: h.gather(xf),
        mesh=mesh,
        in_specs=(P(None, "e"), specs),
        out_specs=P(None, "e"),
    )
    for c in disc.xf:
        got = f(c, halo)
        # periodic wrapping: coordinates agree modulo the period
        d = np.abs(np.asarray(got) - np.asarray(c))
        assert np.all((d < 1e-10) | (np.abs(d - 2.0) < 1e-10))


def test_sharded_time_integration():
    """Full LSRK45 trajectory under the halo-exchange RHS matches the
    single-device trajectory."""
    disc, q = _tri_setup(k1d=8, n=2)
    rhs_ref = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    qf_ref, _ = jax.jit(lambda q0: lsrk45(rhs_ref, q0, 1e-3, 5))(q)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    rhs_sm = make_sharded_euler_rhs(
        mesh, disc, dissipation=True, compute_rhstest=False
    )
    qf_sm, _ = jax.jit(lambda q0: lsrk45(rhs_sm, q0, 1e-3, 5))(q)
    np.testing.assert_allclose(
        np.asarray(qf_sm), np.asarray(qf_ref), rtol=1e-11, atol=1e-11
    )


def test_halo_rejects_non_neighbor_partition():
    vx, vy, vz, etov = uniform_hex_mesh(2)
    disc = build_discretization(
        ref_hex(1), (vx, vy, vz), etov, periodic_axes=(0, 1, 2)
    )
    with pytest.raises(ValueError):
        build_halo_exchange(disc, 8)  # slabs of 1 element: y/z neighbors far


def test_shard_map_cns_periodic_equivalence():
    """Sharded CNS RHS (3 halo exchanges) matches single-device on a
    periodic viscous problem."""
    from esdg_cns_tpu.parallel import make_sharded_cns_rhs
    from esdg_cns_tpu.solvers import make_cns_rhs

    disc, q = _tri_setup(k1d=8, n=2)
    kw = dict(mu=1e-2, pr=0.72, inviscid_dissipation=True,
              viscous_dissipation=True)
    dq_ref, aux_ref = jax.jit(make_cns_rhs(disc, **kw))(q)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    dq_sm, aux_sm = jax.jit(make_sharded_cns_rhs(mesh, disc, **kw))(q)
    np.testing.assert_allclose(
        np.asarray(dq_sm), np.asarray(dq_ref), rtol=1e-11, atol=1e-11
    )
    np.testing.assert_allclose(
        float(aux_sm["rhstest_visc"]), float(aux_ref["rhstest_visc"]),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        float(aux_sm["rhstest"]), float(aux_ref["rhstest"]), atol=1e-9
    )


def _hex_setup(k1d=8, n=2):
    from esdg_cns_tpu.presets import euler_hex_3d

    return euler_hex_3d(n=n, k1d=k1d)


@pytest.mark.parametrize("what", ["rhs", "lsrk45"])
@pytest.mark.parametrize("problem", ["euler_lines", "cns3d_affine"])
def test_sharded_hex_matches_single_device(problem, what):
    """The hex production paths under shard_map + ring ppermute halo
    (z-layer slabs): Euler with line-sparse flux differencing (periodic)
    and the 3D CNS cavity on the composed affine operators (wall BCs)
    match the single-device RHS, and five LSRK45 steps track the
    single-device trajectory."""
    from esdg_cns_tpu.parallel.sharding import make_sharded_cns_rhs_affine
    from esdg_cns_tpu.presets import lid_driven_cavity_3d
    from esdg_cns_tpu.solvers import make_cns_rhs_affine

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    if problem == "euler_lines":
        disc, q = _hex_setup()
        kw = dict(dissipation=True, flux_diff_impl="lines",
                  compute_rhstest=what == "rhs")
        ref = make_euler_rhs(disc, **kw)
        sm = make_sharded_euler_rhs(mesh, disc, **kw)
    else:
        disc, q, bc, p = lid_driven_cavity_3d(n=2, k1d=8)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                  inviscid_dissipation=True, viscous_dissipation=True,
                  flux_diff_impl="lines", compute_rhstest=what == "rhs")
        ref = make_cns_rhs_affine(disc, **kw)
        sm = make_sharded_cns_rhs_affine(mesh, disc, **kw)
    if what == "rhs":
        (a, aux_a), (b, aux_b) = jax.jit(ref)(q), jax.jit(sm)(q)
        np.testing.assert_allclose(float(aux_b["rhstest"]),
                                   float(aux_a["rhstest"]), atol=1e-10)
    else:
        a = jax.jit(lambda q0: lsrk45(ref, q0, 1e-3, 5)[0])(q)
        b = jax.jit(lambda q0: lsrk45(sm, q0, 1e-3, 5)[0])(q)
    scale = float(jnp.abs(a).max())
    np.testing.assert_allclose(np.asarray(b) / scale, np.asarray(a) / scale,
                               rtol=1e-12, atol=1e-12)


def test_pjit_cavity_wall_bc_equivalence():
    """Wall-BC CNS (the reference's headline cavity workload) under
    pjit/SPMD element sharding matches single device: the boundary
    masks are replicated closure constants; XLA partitions the blends."""
    from esdg_cns_tpu.presets import lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=8)  # K=128
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    dq_ref, aux_ref = jax.jit(make_cns_rhs(disc, **kw))(q0)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, q_s = shard_discretization(mesh, "e", disc, q0)
    dq_s, aux_s = jax.jit(make_cns_rhs(disc_s, **kw))(q_s)
    np.testing.assert_allclose(
        np.asarray(dq_s), np.asarray(dq_ref), rtol=1e-11, atol=1e-11
    )
    np.testing.assert_allclose(
        float(aux_s["rhstest"]), float(aux_ref["rhstest"]), atol=1e-9
    )
    np.testing.assert_allclose(
        float(aux_s["rhstest_visc"]), float(aux_ref["rhstest_visc"]),
        rtol=1e-9,
    )


def test_pjit_dopri45_cavity_adaptive():
    """Adaptive DOPRI45 under pjit: the Hairer-seminorm error estimate
    is a global jnp.mean reduction (a psum under SPMD), so the sharded
    run takes the same accept/reject decisions and trajectory as the
    single-device run."""
    from esdg_cns_tpu.presets import lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs
    from esdg_cns_tpu.timestepping import dopri45

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=8)
    rhs = make_cns_rhs(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        compute_rhstest=False,
    )
    dt0 = 1e-3
    t_end = 5e-3

    step = jax.jit(lambda q: dopri45(rhs, q, t_end, dt0, err_tol=1e-5))
    qf_ref, st_ref = step(q0)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, q_s = shard_discretization(mesh, "e", disc, q0)
    rhs_s = make_cns_rhs(
        disc_s, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        compute_rhstest=False,
    )
    qf_s, st_s = jax.jit(lambda q: dopri45(rhs_s, q, t_end, dt0,
                                           err_tol=1e-5))(q_s)
    assert int(st_s["n_accepted"]) == int(st_ref["n_accepted"])
    assert int(st_s["n_rejected"]) == int(st_ref["n_rejected"])
    np.testing.assert_allclose(
        np.asarray(qf_s), np.asarray(qf_ref), rtol=1e-9, atol=1e-9
    )


def test_shard_map_dopri45_matches_single_device():
    """Adaptive stepping over the shard_map halo RHS: dopri45 runs on
    the global state outside shard_map, so its error estimate is a
    global reduction there too."""
    from esdg_cns_tpu.parallel import make_sharded_cns_rhs
    from esdg_cns_tpu.solvers import make_cns_rhs
    from esdg_cns_tpu.timestepping import dopri45

    disc, q = _tri_setup(k1d=8, n=2)
    kw = dict(mu=1e-2, pr=0.72, inviscid_dissipation=True,
              viscous_dissipation=True, compute_rhstest=False)
    rhs_ref = make_cns_rhs(disc, **kw)
    dt0, t_end = 1e-3, 5e-3
    qf_ref, st_ref = jax.jit(
        lambda q0: dopri45(rhs_ref, q0, t_end, dt0, err_tol=1e-5)
    )(q)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    rhs_sm = make_sharded_cns_rhs(mesh, disc, **kw)
    qf_sm, st_sm = jax.jit(
        lambda q0: dopri45(rhs_sm, q0, t_end, dt0, err_tol=1e-5)
    )(q)
    assert int(st_sm["n_accepted"]) == int(st_ref["n_accepted"])
    np.testing.assert_allclose(
        np.asarray(qf_sm), np.asarray(qf_ref), rtol=1e-9, atol=1e-9
    )


def test_shard_map_cavity_wall_bc_equivalence():
    """Wall-BC cavity on the EXPLICIT halo path (round-3 lift of the
    pjit-only restriction): the WallBC pytree's [Nfq, K] leaves (region
    masks, normals, lid profile) shard along the element axis, and the
    slab halo handles the non-periodic mesh via union send patterns."""
    from esdg_cns_tpu.parallel.sharding import make_sharded_cns_rhs_affine
    from esdg_cns_tpu.presets import lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs_affine

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=8, bctype="isothermal")
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    dq_ref, aux_ref = jax.jit(make_cns_rhs_affine(disc, **kw))(q0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    dq_sm, aux_sm = jax.jit(make_sharded_cns_rhs_affine(mesh, disc, **kw))(q0)
    np.testing.assert_allclose(np.asarray(dq_sm), np.asarray(dq_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(aux_sm["rhstest"]),
                               float(aux_ref["rhstest"]), atol=1e-12)


def test_shard_map_cavity_3d_wall_bc():
    """3D lid-driven cavity (beyond-reference capability) on the
    explicit halo path: z-layer slabs, wall BCs on all six faces."""
    from esdg_cns_tpu.parallel.sharding import make_sharded_cns_rhs_affine
    from esdg_cns_tpu.presets import lid_driven_cavity_3d
    from esdg_cns_tpu.solvers import make_cns_rhs_affine

    disc, q0, bc, p = lid_driven_cavity_3d(n=2, k1d=8)
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    dq_ref, aux_ref = jax.jit(make_cns_rhs_affine(disc, **kw))(q0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    dq_sm, aux_sm = jax.jit(make_sharded_cns_rhs_affine(mesh, disc, **kw))(q0)
    np.testing.assert_allclose(np.asarray(dq_sm), np.asarray(dq_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(aux_sm["rhstest"]),
                               float(aux_ref["rhstest"]), atol=1e-12)


def test_shard_map_rejects_dirichlet_closures():
    """Dirichlet regions close over global-shaped arrays; the halo path
    must refuse them loudly (pjit path handles them)."""
    from esdg_cns_tpu.parallel.sharding import make_sharded_cns_rhs
    from esdg_cns_tpu.presets import becker_shocktube_2d

    disc, q0, bc, shock = becker_shocktube_2d(n=2, k1d=8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    with pytest.raises(ValueError, match="dirichlet"):
        make_sharded_cns_rhs(mesh, disc, mu=shock.mu, pr=0.72, bc=bc)


def test_pjit_implicit_midpoint_matches_single_device():
    """The implicit path under SPMD sharding (new in round 4): one
    Newton-GMRES implicit midpoint step with the element axis sharded
    over 8 devices must match the single-device solve.  Everything in
    newton_krylov_step (GMRES dot products, residual norms, the
    while_loop) is global arithmetic that GSPMD turns into cross-device
    collectives automatically — the distributed analogue of the
    reference's sparse direct solve (implicit_euler_2D.jl:188)."""
    from esdg_cns_tpu.timestepping.implicit import implicit_midpoint

    disc, q = _tri_setup(k1d=8, n=2)
    rhs = make_euler_rhs(disc, dissipation=True, compute_rhstest=False)
    rhs_aux = lambda qq, t=0.0: (rhs(qq, t)[0], {})
    dt = 1e-3
    step = lambda d, qq: implicit_midpoint(
        lambda x, t=0.0: (make_euler_rhs(d, dissipation=True,
                                         compute_rhstest=False)(x, t)[0], {}),
        qq, dt, 1)

    qf_ref, aux_ref = jax.jit(lambda qq: implicit_midpoint(rhs_aux, qq,
                                                           dt, 1))(q)
    assert float(aux_ref["newton_residual"].max()) < 1e-10

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, q_s = shard_discretization(mesh, "e", disc, q)
    qf_s, aux_s = jax.jit(lambda qq: step(disc_s, qq))(q_s)
    assert float(aux_s["newton_residual"].max()) < 1e-10
    np.testing.assert_allclose(np.asarray(qf_s), np.asarray(qf_ref),
                               rtol=1e-10, atol=1e-10)


def test_build_problem_device_mesh():
    """One-call SPMD through the typed config: build_problem(...,
    device_mesh=...) shards the discretization before the RHS closes
    over it, so run_simulation partitions automatically and matches the
    unsharded run."""
    from esdg_cns_tpu.config import SimConfig, build_problem, run_simulation

    cfg = SimConfig(equation="euler", elem_type="tri", n=2, k1d=8,
                    t_end=2e-3, stepper="lsrk45", dt=1e-3)
    disc, rhs = build_problem(cfg)
    rng = np.random.default_rng(0)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    qf_ref, aux_ref = run_simulation(cfg, q0, rhs)

    mesh = Mesh(np.array(jax.devices()[:8]), ("e",))
    disc_s, rhs_s = build_problem(cfg, device_mesh=mesh)
    # state placed on the same sharding inherits the partitioning
    from jax.sharding import NamedSharding
    q0_s = jax.device_put(q0, NamedSharding(mesh, P(None, None, "e")))
    qf_s, aux_s = run_simulation(cfg, q0_s, rhs_s)
    np.testing.assert_allclose(np.asarray(qf_s), np.asarray(qf_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(aux_s["rhstest"][-1]),
                               float(aux_ref["rhstest"][-1]), atol=1e-10)

    with pytest.raises(ValueError, match="divisible"):
        build_problem(SimConfig(equation="euler", elem_type="tri", n=2,
                                k1d=3), device_mesh=mesh)


def test_2d_device_mesh_ensemble_by_elements():
    """DP x domain-decomposition on ONE 2D device mesh ("ens" x "e"):
    a batch of simulations vmapped on the leading axis AND the element
    axis sharded, in one SPMD program — the scaling-book mesh-axis
    composition.  Matches the single-device vmapped RHS to f64
    reduction-order roundoff."""
    disc, _ = _tri_setup(k1d=8, n=2)
    rng = np.random.default_rng(7)
    b = 2
    sh = (b, disc.np_, disc.num_elements)
    from esdg_cns_tpu.physics import primitive_to_conservative as p2c
    qb = jax.vmap(p2c)(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((b, 2, *sh[1:]))),
        jnp.asarray(2 + 0.1 * rng.random(sh)),
    )
    rhs = make_euler_rhs(disc, dissipation=True)
    ref = jax.jit(jax.vmap(lambda q: rhs(q)[0]))(qb)

    from jax.sharding import NamedSharding
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("ens", "e"))
    disc_s, _ = shard_discretization(mesh2, "e", disc)
    rhs_s = make_euler_rhs(disc_s, dissipation=True)
    qb_s = jax.device_put(qb, NamedSharding(mesh2, P("ens", None, None, "e")))
    out = jax.jit(jax.vmap(lambda q: rhs_s(q)[0]))(qb_s)
    scale = float(jnp.abs(ref).max())
    np.testing.assert_allclose(np.asarray(out) / scale,
                               np.asarray(ref) / scale,
                               rtol=1e-11, atol=1e-11)
