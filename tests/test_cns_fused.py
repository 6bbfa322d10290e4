"""Affine composed-operator CNS RHS (solvers.cns_fused) equivalence.

make_cns_rhs_affine is a pure operator-algebra re-association of
make_cns_rhs (commuting per-element affine geometric factors through
the reference-element operators), so it must match to roundoff on any
affine mesh, BCs included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.physics import BeckerShock
from esdg_cns_tpu.presets import becker_shocktube_2d, lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs, make_cns_rhs_affine


def _configs():
    disc, q0, bc, p = lid_driven_cavity(n=3, k1d=6)
    yield "cavity", disc, q0, bc, dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    disc, q0, bc, shock = becker_shocktube_2d(
        n=2, k1d=6, shock=BeckerShock(mu=0.1)
    )
    yield "becker2d", disc, q0, bc, dict(mu=shock.mu, pr=shock.pr)


@pytest.mark.parametrize("cfg", list(_configs()), ids=lambda c: c[0])
def test_affine_matches_reference_path(cfg):
    name, disc, q0, bc, kw = cfg
    rng = np.random.default_rng(0)
    q = q0 + 5e-4 * jnp.asarray(rng.standard_normal(q0.shape)) \
        * jnp.asarray([1.0, 0.1, 0.1, 1.0])[:, None, None]
    flags = dict(bc=bc, inviscid_dissipation=True, viscous_dissipation=True,
                 **kw)
    dq_a, aux_a = jax.jit(make_cns_rhs(disc, **flags))(q, 0.0)
    dq_b, aux_b = jax.jit(make_cns_rhs_affine(disc, **flags))(q, 0.0)
    scale = float(jnp.abs(dq_a).max())
    assert float(jnp.abs(dq_a - dq_b).max()) < 1e-10 * scale
    for key in ("rhstest", "rhstest_visc", "rhstest_visc_total"):
        va, vb = float(aux_a[key]), float(aux_b[key])
        assert abs(va - vb) < 1e-9 * max(abs(va), 1.0), (key, va, vb)


@pytest.mark.parametrize("n", [2, 4])
def test_lines_matches_xla_3d_cavity(n):
    """The 3D cavity's production volume stage (line-sparse flux
    differencing on collocated hexes) == the dense all-pairs 'xla'
    contraction through the same affine builder, wall BCs and both
    dissipations on (n=4 is the misaligned-order case)."""
    from esdg_cns_tpu.presets import lid_driven_cavity_3d

    disc, q0, bc, p = lid_driven_cavity_3d(n=n, k1d=2)
    rng = np.random.default_rng(1)
    q = q0 + 5e-4 * jnp.asarray(rng.standard_normal(q0.shape)) \
        * jnp.asarray([1.0, 0.1, 0.1, 0.1, 1.0])[:, None, None]
    flags = dict(bc=bc, mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True)
    dq_a, aux_a = jax.jit(make_cns_rhs_affine(
        disc, **flags, flux_diff_impl="xla"))(q, 0.0)
    dq_b, aux_b = jax.jit(make_cns_rhs_affine(
        disc, **flags, flux_diff_impl="lines"))(q, 0.0)
    scale = float(jnp.abs(dq_a).max())
    assert float(jnp.abs(dq_a - dq_b).max()) < 1e-10 * scale
    for key in ("rhstest", "rhstest_visc", "rhstest_visc_total"):
        va, vb = float(aux_a[key]), float(aux_b[key])
        assert abs(va - vb) < 1e-9 * max(abs(va), 1.0), (key, va, vb)


def test_removed_kernel_options_raise():
    """The removed kernel selectors are gone: passing one is an error, never
    a silent fallback."""
    disc, _, bc, p = lid_driven_cavity(n=2, k1d=2)
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc)
    for opt in (dict(volume_impl="fused"), dict(viscous_impl="fused"),
                dict(surface_impl="merged"), dict(interpret=True)):
        with pytest.raises(TypeError):
            make_cns_rhs_affine(disc, **kw, **opt)
    for impl in ("pallas", "lines_pallas", "fused"):
        with pytest.raises(ValueError):
            make_cns_rhs_affine(disc, **kw, flux_diff_impl=impl)


def test_affine_requires_affine_mesh():
    from esdg_cns_tpu.presets import euler_hex_3d

    disc, _ = euler_hex_3d(n=2, k1d=2, curved=True)
    with pytest.raises(ValueError):
        make_cns_rhs_affine(disc, mu=0.01)


def test_affine_entropy_stability_cavity():
    """Dissipation flags on: entropy is produced viscously and the
    total balance stays <= 0 through the affine path as well.

    Uses ADIABATIC walls and a zero-velocity lid: a moving lid does
    work on the fluid and an isothermal wall exchanges heat with a
    perturbed (T != T_wall) fluid, so both can legitimately make
    rhstest > 0 (identically through either RHS path); the adiabatic
    no-slip wall at rest is the case with the clean nonpositive
    semi-discrete bound."""
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, bctype="adiabatic",
                                        lid_profile=lambda x: 0.0 * x)
    rng = np.random.default_rng(1)
    q = q0 + 1e-3 * jnp.asarray(rng.standard_normal(q0.shape)) \
        * jnp.asarray([1.0, 0.1, 0.1, 1.0])[:, None, None]
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
    )
    _, aux = jax.jit(rhs)(q, 0.0)
    assert float(aux["rhstest_visc"]) >= 0.0
    assert float(aux["rhstest"]) < 1e-10


@pytest.mark.parametrize("case", ["adiabatic", "isothermal", "slip",
                                  "lid_profile", "dirichlet", "nobc",
                                  "hex3d"])
def test_affine_matches_generic_bc_cases(case):
    """The composed-operator affine RHS == the generic make_cns_rhs, to
    roundoff, across every BC shape: the three wall kinds, an ARRAY lid
    profile, time-dependent Dirichlet ghosts, no BC at all, and the 3D
    collocated-hex cavity."""
    t = 0.0
    if case == "dirichlet":
        disc, q0, bc, shock = becker_shocktube_2d(
            n=2, k1d=3, shock=BeckerShock(mu=0.1))
        kw = dict(mu=shock.mu, pr=shock.pr)
        t = 0.037
    elif case == "nobc":
        disc, q0, _, shock = becker_shocktube_2d(
            n=2, k1d=3, shock=BeckerShock(mu=0.1))
        bc = None
        kw = dict(mu=shock.mu, pr=shock.pr)
    elif case == "lid_profile":
        from esdg_cns_tpu.verification import regularized_lid

        disc, q0, bc, p = lid_driven_cavity(n=2, k1d=3,
                                            bctype="isothermal",
                                            lid_profile=regularized_lid)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    elif case == "hex3d":
        from esdg_cns_tpu.presets import lid_driven_cavity_3d

        disc, q0, bc, p = lid_driven_cavity_3d(n=2, k1d=2)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    else:
        disc, q0, bc, p = lid_driven_cavity(n=2, k1d=3, bctype=case)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    rng = np.random.default_rng(3)
    q = q0 * (1.0 + 0.01 * jnp.asarray(rng.standard_normal(q0.shape)))
    flags = dict(bc=bc, inviscid_dissipation=True,
                 viscous_dissipation=True, **kw)
    dq_g, aux_g = jax.jit(make_cns_rhs(disc, **flags))(q, t)
    dq_a, aux_a = jax.jit(make_cns_rhs_affine(disc, **flags))(q, t)
    scale = float(jnp.abs(dq_g).max())
    d = float(jnp.abs(dq_a - dq_g).max())
    assert d < 1e-10 * scale, (case, d, scale)
    for key in ("rhstest", "rhstest_visc", "rhstest_visc_total"):
        va, vb = float(aux_g[key]), float(aux_a[key])
        assert abs(va - vb) < 1e-9 * max(abs(va), 1.0), (case, key, va, vb)


def test_rebuilt_jump_bitwise_antisymmetric():
    """The comm-avoiding design invariant (docs/design.md): with BOTH
    sides of every conforming face rebuilding the entropy/conservative
    traces from the SAME exchanged flux-variable payload, the BR1 jump
    dv = rebuild(gather(tr)) - rebuild(tr) is BITWISE antisymmetric
    across faces (side B evaluates the identical subtraction with
    operands swapped, and fl(a-b) == -fl(b-a) exactly in IEEE
    arithmetic).  The mixed exact/rebuilt scheme of rounds <4 only
    achieved roundoff-level antisymmetry.  Checked on a fully periodic
    tri mesh where gather is the involutive mapP permutation."""
    from esdg_cns_tpu.core import build_discretization, ref_tri
    from esdg_cns_tpu.mesh import uniform_tri_mesh
    from esdg_cns_tpu.solvers._shared import (
        entropy_vars_from_flux,
        flux_to_conservative,
    )

    vx, vy, etov = uniform_tri_mesh(6)
    disc = build_discretization(ref_tri(2), (vx, vy), etov,
                                periodic_axes=(0, 1))
    rng = np.random.default_rng(3)
    sh = (disc.nfq, disc.num_elements)
    qm = jnp.stack([
        jnp.asarray(0.5 + rng.random(sh)),        # rho
        jnp.asarray(rng.standard_normal(sh)),     # u
        jnp.asarray(rng.standard_normal(sh)),     # v
        jnp.asarray(0.5 + rng.random(sh)),        # beta
    ])
    logs = jnp.stack([jnp.log(qm[0]), jnp.log(qm[-1])])

    gather = disc.gather_traces
    qp, logp = gather(qm), gather(logs)
    # gather must be an involutive permutation on this mesh
    np.testing.assert_array_equal(np.asarray(gather(qp)), np.asarray(qm))

    dv = entropy_vars_from_flux(qp, logp, 1.4) - entropy_vars_from_flux(
        qm, logs, 1.4)
    du = flux_to_conservative(qp, 1.4) - flux_to_conservative(qm, 1.4)
    # bitwise: the gathered jump IS the negated jump, no tolerance
    np.testing.assert_array_equal(np.asarray(gather(dv)), np.asarray(-dv))
    np.testing.assert_array_equal(np.asarray(gather(du)), np.asarray(-du))


def test_natural_boundary_traction_on_self_mapped_faces():
    """Contracted stress exchange, bc=None / uncovered boundary faces:
    the neighbor traction at SELF-MAPPED faces must be the natural
    t_pn = t_f (zero viscous jump), exactly as the pre-contraction
    per-component self-gather gave sigma_p == sigma_m — not the
    interior rule -t_ex, which flips the traction sign when the
    gather returns the local value itself."""
    from esdg_cns_tpu.solvers._shared import neighbor_traction
    from esdg_cns_tpu.solvers.boundary import WallBC

    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=3)
    bmask = np.asarray(disc.bmask)
    assert bmask.any()  # the cavity mesh has true boundary faces
    rng = np.random.default_rng(7)
    t_f = jnp.asarray(rng.standard_normal((4, disc.nfq,
                                           disc.num_elements)))
    t_ex = disc.gather_traces(t_f)
    # self-gather precondition: boundary faces read back their own value
    np.testing.assert_array_equal(np.asarray(t_ex)[:, bmask],
                                  np.asarray(t_f)[:, bmask])

    t_pn = np.asarray(neighbor_traction(disc, None, t_f, t_ex))
    np.testing.assert_array_equal(t_pn[:, bmask], np.asarray(t_f)[:, bmask])
    np.testing.assert_array_equal(t_pn[:, ~bmask],
                                  np.asarray(-t_ex)[:, ~bmask])

    # WallBC path: faces of dropped regions fall back to natural too
    pruned = WallBC(regions=bc.regions[:1], nhat=bc.nhat,
                    bmask=bc.bmask, dim=bc.dim)
    covered = np.asarray(bc.regions[0].mask)
    t_pb = np.asarray(neighbor_traction(disc, pruned, t_f, t_ex))
    uncovered = bmask & ~covered
    assert uncovered.any()
    np.testing.assert_array_equal(t_pb[:, uncovered],
                                  np.asarray(t_f)[:, uncovered])
    np.testing.assert_array_equal(t_pb[:, ~bmask],
                                  np.asarray(-t_ex)[:, ~bmask])
