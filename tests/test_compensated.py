"""Compensated entropy-residual reduction (utils.compensated).

A native f32 entropy residual is dominated by the diagnostic's own
accumulation roundoff.  These
tests pin the double-float Dot2 reduction to f64 ground truth and wire
it through the RHS builders' rhstest_mode knob.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esdg_cns_tpu.presets import euler_hex_3d
from esdg_cns_tpu.solvers import make_euler_rhs
from esdg_cns_tpu.utils.compensated import (
    dot3_compensated,
    weighted_entropy_residual,
)


def _f64_truth(w, v, r):
    w64 = np.asarray(w, np.float64)[None]
    v64 = np.asarray(v, np.float64)
    r64 = np.asarray(r, np.float64)
    terms = w64 * v64 * r64
    return terms.sum(), np.abs(terms).sum()


def test_dot3_compensated_vs_f64_cancellation():
    """Near-cancelling f32 sum: compensated must hit ~eps^2 accuracy."""
    rng = np.random.default_rng(0)
    n, k = 7, 5000
    v = rng.standard_normal((3, n, k)).astype(np.float32)
    # antisymmetric r makes the true sum tiny relative to sum|terms|
    r_half = rng.standard_normal((3, n, k // 2)).astype(np.float32)
    r = np.concatenate([r_half, -r_half], axis=-1)
    w = np.abs(rng.standard_normal((n, k))).astype(np.float32)
    v[..., k // 2:] = v[..., : k // 2]
    w[..., k // 2:] = w[..., : k // 2]

    truth, scale = _f64_truth(w, v, r)
    assert abs(truth) < 1e-12 * scale  # construction sanity

    comp = jax.jit(dot3_compensated)(
        jnp.asarray(w)[None], jnp.asarray(v), jnp.asarray(r)
    )
    assert abs(float(comp) - truth) < 1e-9 * scale


def test_dot3_compensated_generic():
    rng = np.random.default_rng(1)
    w = np.abs(rng.standard_normal((11, 333))).astype(np.float32)
    v = rng.standard_normal((4, 11, 333)).astype(np.float32)
    r = rng.standard_normal((4, 11, 333)).astype(np.float32)
    truth, scale = _f64_truth(w, v, r)
    comp = float(dot3_compensated(jnp.asarray(w)[None], jnp.asarray(v),
                                  jnp.asarray(r)))
    assert abs(comp - truth) < 1e-9 * scale


def test_weighted_entropy_residual_modes():
    rng = np.random.default_rng(2)
    w = jnp.asarray(np.abs(rng.standard_normal((6, 64))), jnp.float32)
    v = jnp.asarray(rng.standard_normal((5, 6, 64)), jnp.float32)
    r = jnp.asarray(rng.standard_normal((5, 6, 64)), jnp.float32)
    truth, scale = _f64_truth(w, v, r)
    for mode in ("native", "compensated", "f64"):
        out = float(weighted_entropy_residual(w, v, r, mode))
        assert abs(out - truth) < 1e-5 * scale
    assert abs(float(weighted_entropy_residual(w, v, r, "f64")) - truth) \
        < 1e-12 * scale
    with pytest.raises(ValueError):
        weighted_entropy_residual(w, v, r, "bogus")


def test_rhstest_mode_on_f32_euler_rhs():
    """The knob end-to-end: f32 hex Euler, dissipation off.

    'compensated' must agree with the f64 reduction of the SAME f32 rhs
    to double-float accuracy — i.e. the diagnostic's own roundoff is
    eliminated and what remains is the genuine f32 entropy defect.
    """
    disc, q0 = euler_hex_3d(n=2, k1d=4, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    q = q0 + 0.05 * jnp.asarray(
        rng.standard_normal(q0.shape), jnp.float32
    ) * jnp.asarray([1.0, 0.1, 0.1, 0.1, 1.0])[:, None, None]

    rts = {}
    for mode in ("native", "compensated", "f64"):
        rhs = make_euler_rhs(
            disc, dissipation=False, flux_diff_impl="lines",
            rhstest_mode=mode,
        )
        _, aux = jax.jit(rhs)(q)
        rts[mode] = float(aux["rhstest"])

    # scale of the reduction for tolerance normalization
    from esdg_cns_tpu.solvers.euler import _apply
    from esdg_cns_tpu.physics import euler as phys

    dq, _ = jax.jit(make_euler_rhs(disc, dissipation=False,
                                   flux_diff_impl="lines"))(q)
    vu = phys.v_ufun(_apply(disc.vq, q.astype(jnp.float64)), phys.GAMMA)
    scale = float(jnp.sum(jnp.abs(
        disc.wjq[None] * vu *
        _apply(disc.vq, dq.astype(jnp.float64))
    )))

    assert abs(rts["compensated"] - rts["f64"]) < 1e-8 * scale
    # all modes agree at f32 level
    assert abs(rts["native"] - rts["f64"]) < 1e-4 * scale
