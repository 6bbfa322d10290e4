"""Double-float (df64) arithmetic and the df64 verification RHS.

The acceptance this backs: the reference reaches machine-zero entropy
residuals in native Float64 (dg2D_euler_tri.jl:177-183); in f32 state
arithmetic the df64 RHS must reproduce that.  These tests run the
SAME f32-pair arithmetic on CPU (conftest pins --xla_cpu_max_isa=AVX so
x86 FMA contraction cannot destroy the error-free transforms) and
check it against true f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.utils import df64 as D


def test_verify_eft_on_this_backend():
    """The jitted EFT probe must pass (guards against compiler fusion
    regressions — FMA contraction once turned renorm into fl(p+2e))."""
    assert D.verify_eft() < 1e-13


def test_df_primitives_vs_f64():
    rng = np.random.default_rng(0)
    x64 = np.exp(rng.uniform(-3, 3, 4096))
    y64 = np.exp(rng.uniform(-3, 3, 4096))
    x = D.df_split_array(x64)
    y = D.df_split_array(y64)

    def rel(a_df, want):
        return np.abs((D.df_to_f64(a_df) - want) / want).max()

    assert rel(jax.jit(D.df_add)(x, y), x64 + y64) < 1e-13
    assert rel(jax.jit(D.df_mul)(x, y), x64 * y64) < 1e-13
    assert rel(jax.jit(D.df_div)(x, y), x64 / y64) < 1e-13
    assert rel(jax.jit(D.df_sqrt)(x), np.sqrt(x64)) < 1e-13
    z64 = rng.uniform(-20, 20, 4096)
    assert rel(jax.jit(D.df_exp)(D.df_split_array(z64)), np.exp(z64)) < 1e-12
    got = D.df_to_f64(jax.jit(D.df_log)(x))
    assert np.abs(got - np.log(x64)).max() < 1e-13   # absolute: log ~ 0
    assert rel(jax.jit(lambda a: D.df_pow(a, 2.5))(x), x64**2.5) < 1e-13
    assert rel(jax.jit(lambda a: D.df_pow(a, -1.4 / 0.4))(x),
               x64**-3.5) < 1e-13


def test_df_constants_are_split():
    """Inexact constants (gamma-1 = 0.4) must not be f32-rounded: the
    f32 rounding alone is 1.5e-8 relative, measured to cap the whole
    RHS at f32 accuracy before df_mul_c existed."""
    x64 = np.array([1.7, 3.14, 0.2])
    x = D.df_split_array(x64)
    got = D.df_to_f64(jax.jit(lambda a: D.df_mul_c(a, 0.4))(x))
    assert np.abs(got - 0.4 * x64).max() < 2e-14   # df floor ~|x| 2^-48
    got = D.df_to_f64(jax.jit(lambda a: D.df_add_c(a, 2.4))(x))
    assert np.abs(got - (2.4 + x64)).max() < 2e-14


def test_logmean_df_matches_f64():
    from esdg_cns_tpu.physics.euler import logmean
    from esdg_cns_tpu.solvers.euler_df64 import logmean_df

    rng = np.random.default_rng(1)
    al64 = np.exp(rng.uniform(-1, 1, 4096))
    # include near-equal pairs (series branch) and far pairs (log branch)
    ar64 = al64 * np.exp(rng.uniform(-1, 1, 4096))
    ar64[:100] = al64[:100] * (1 + 1e-6 * rng.standard_normal(100))
    a_l = D.df_split_array(al64)
    a_r = D.df_split_array(ar64)
    got = D.df_to_f64(jax.jit(logmean_df)(
        a_l, a_r, jax.jit(D.df_log)(a_l), jax.jit(D.df_log)(a_r)
    ))
    want = np.asarray(logmean(jnp.asarray(al64), jnp.asarray(ar64)))
    assert np.abs((got - want) / want).max() < 1e-12


@pytest.mark.parametrize("dissipation", [False, True])
def test_df64_rhs_matches_f64(dissipation):
    """The full df64 collocated-hex RHS agrees with the true-f64 RHS at
    the same f32 state, and its entropy residual is at the f64 level —
    the double-float acceptance semantics."""
    from esdg_cns_tpu.presets import euler_hex_3d
    from esdg_cns_tpu.solvers import make_euler_rhs
    from esdg_cns_tpu.solvers.euler_df64 import make_euler_rhs_df64

    disc, q0, host = euler_hex_3d(n=2, k1d=2, dtype=jnp.float32,
                                  return_host=True)
    disc64, _ = euler_hex_3d(n=2, k1d=2, dtype=jnp.float64)

    rhs_df = jax.jit(make_euler_rhs_df64(disc, host, dissipation=dissipation))
    dq_hi, aux = rhs_df(q0)
    dq_df = np.asarray(dq_hi, np.float64) + np.asarray(aux["dq_lo"],
                                                       np.float64)

    rhs64 = make_euler_rhs(disc64, dissipation=dissipation,
                           flux_diff_impl="lines")
    dq_ref, aux_ref = jax.jit(rhs64)(jnp.asarray(np.asarray(q0, np.float64)))
    dq_ref = np.asarray(dq_ref)

    rel = np.abs(dq_df - dq_ref).max() / np.abs(dq_ref).max()
    assert rel < 1e-11, rel
    if not dissipation:
        # entropy conservation at the f64 acceptance level, computed
        # entirely in f32-pair arithmetic
        assert abs(float(aux["rhstest"])) < 1e-12
    else:
        np.testing.assert_allclose(float(aux["rhstest"]),
                                   float(aux_ref["rhstest"]), rtol=1e-6)


def test_df64_rhs_modal_tri_matches_f64():
    """The MODAL (tri) df64 branch — dense q_skew all-pairs fd, full
    Vq/VhP entropy projection — matches the true-f64 RHS and attains
    f64-level entropy conservation (the reference's original
    acceptance configuration, dg2D_euler_tri.jl:177-183)."""
    from esdg_cns_tpu.core import build_discretization, ref_tri
    from esdg_cns_tpu.mesh import uniform_tri_mesh
    from esdg_cns_tpu.physics import primitive_to_conservative
    from esdg_cns_tpu.solvers import make_euler_rhs
    from esdg_cns_tpu.solvers.euler_df64 import make_euler_rhs_df64

    vx, vy, etov = uniform_tri_mesh(3)
    disc, host = build_discretization(
        ref_tri(2), (vx, vy), etov, periodic_axes=(0, 1),
        dtype=jnp.float32, return_host=True,
    )
    disc64 = build_discretization(ref_tri(2), (vx, vy), etov,
                                  periodic_axes=(0, 1), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh), jnp.float32),
        jnp.asarray(0.3 * rng.standard_normal((2, *sh)), jnp.float32),
        jnp.asarray(2 + 0.1 * rng.random(sh), jnp.float32),
    )
    dq_hi, aux = jax.jit(make_euler_rhs_df64(disc, host,
                                             dissipation=False))(q0)
    dq_df = (np.asarray(dq_hi, np.float64)
             + np.asarray(aux["dq_lo"], np.float64))
    dq_ref, _ = jax.jit(make_euler_rhs(disc64, dissipation=False))(
        jnp.asarray(np.asarray(q0, np.float64)))
    rel = np.abs(dq_df - np.asarray(dq_ref)).max() / np.abs(dq_ref).max()
    assert rel < 1e-11, rel
    assert abs(float(aux["rhstest"])) < 1e-12
