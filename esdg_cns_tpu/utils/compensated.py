"""Compensated (double-float) reductions for f32 diagnostics.

The entropy-balance diagnostic ``rhstest = sum(wJq * v * rhs)`` is a
sum of ~1e6 O(1) terms whose exact value is tiny (zero in exact
arithmetic for the dissipation-free scheme), so a native f32 reduction
buries it under accumulation roundoff.  Every correctly rounded f32 op
is all error-free transformations need: this module
evaluates the triple-product reduction in "double-float" (a value
carried as an unevaluated hi + lo pair, ~2^-48 effective precision)
using Dekker/Knuth two_sum / two_prod building blocks and a log-depth
pairwise tree, i.e. the Ogita-Rump-Oishi Dot2 algorithm vectorized for
XLA.

This isolates the *diagnostic's own* accumulation error; what remains
is the genuine entropy defect of the f32-computed RHS (flux-level
roundoff), which no summation scheme can remove.

No reference counterpart (the reference is all Float64, where the
native sum is already at the 1e-12 acceptance level).
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT_F32 = 4097.0  # 2**12 + 1 (f32: 24-bit mantissa)
_SPLIT_F64 = 134217729.0  # 2**27 + 1


def _two_sum(a, b):
    """Knuth branchless: s + err == a + b exactly.

    Add/subtract chains are safe under XLA on every backend (the
    algebraic simplifier performs no float-invalid reassociation of
    them, verified in the optimized HLO); the FMA-contraction hazard is
    confined to _two_prod's split, handled there.
    """
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _fast_renorm(s, e):
    """Fast two-sum; valid because |s| >= |e| after _two_sum/_df_add."""
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _split(x):
    """Exact high/low mantissa split via bit masking.

    Dekker's multiplicative split (``ca = 4097*x; xh = ca - (ca - x)``)
    is destroyed by FMA contraction: XLA:CPU's LLVM backend fuses
    ``4097*x - x`` into an exact fms, so ``ca`` never rounds and the
    split degenerates (measured: jitted df_mul lost its entire lo part,
    2.8e-8 error where eager gave 2e-15; optimization_barrier does not
    survive XLA:CPU's barrier expander).  Masking the low mantissa bits
    is exact arithmetic-free splitting: every cross product of the
    halves fits the mantissa, so no compiler transform can change the
    result.  f32: keep 12 significant bits (11 explicit + implicit);
    f64: keep 26, low part <= 27 -> all products representable except
    the O(eps^2) lo*lo term.
    """
    from jax import lax

    if x.dtype == jnp.float64:
        int_t, mask = jnp.int64, ~jnp.int64(0x7FFFFFF)
    else:
        int_t, mask = jnp.int32, ~jnp.int32(0xFFF)
    xi = lax.bitcast_convert_type(x, int_t)
    xh = lax.bitcast_convert_type(xi & mask, x.dtype)
    return xh, x - xh


def _two_prod(a, b):
    """p + err == a * b exactly (FMA-contraction-proof; see _split)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b, a.dtype) if not hasattr(b, "dtype") else b
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _df_add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) in double-float."""
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    return _fast_renorm(s, e)


def df_sum(hi, lo):
    """Pairwise-tree sum of double-float numbers; returns (hi, lo) scalars.

    Log-depth halving over CONTIGUOUS halves (pad once to a power of
    two): contiguous slicing keeps every level a plain vector op, where
    stride-2 gathers would add a relayout pass per level.
    """
    hi = hi.ravel()
    lo = lo.ravel()
    n = hi.shape[0]
    n_pow2 = 1 << max(n - 1, 1).bit_length() if n & (n - 1) else n
    if n_pow2 != n:
        pad = jnp.zeros((n_pow2 - n,), hi.dtype)
        hi = jnp.concatenate([hi, pad])
        lo = jnp.concatenate([lo, pad])
    while hi.shape[0] > 1:
        m = hi.shape[0] // 2
        hi, lo = _df_add(hi[:m], lo[:m], hi[m:], lo[m:])
    return hi[0], lo[0]


def dot3_compensated(w, v, r):
    """sum(w * v * r) with double-float products and tree accumulation.

    Each triple product is expanded error-free:
      w*v   = t + e1            (two_prod)
      t*r   = p + e2            (two_prod)
      e1*r  = e3                (its own roundoff is O(eps^2), kept as-is)
    so p + (e2 + e3) == w*v*r to ~eps^2, then the pairwise double-float
    tree makes the global sum exact to ~eps^2 * condition.
    """
    w = jnp.broadcast_to(w, v.shape)
    t, e1 = _two_prod(w, v)
    p, e2 = _two_prod(t, r)
    e = e2 + e1 * r
    hi, lo = df_sum(p, e)
    return hi + lo


def require_exact_mode(mode: str) -> None:
    """Build-time guard: 'compensated' relies on error-free
    transformations, so it refuses a backend that breaks them
    (utils.df64.require_exact_eft)."""
    if mode == "compensated":
        from .df64 import require_exact_eft

        require_exact_eft("rhstest_mode='compensated'")


def weighted_entropy_residual(wjq, v, rhs, mode: str = "native"):
    """Entropy-balance reduction sum(wJq * v * rhs) at selectable accuracy.

    mode:
      'native'      — plain f32/f64 jnp.sum (the round-1 behavior).
      'compensated' — double-float Dot2 (f32 states; isolates the
                      RHS's genuine f32 entropy defect from the
                      diagnostic's own accumulation roundoff).
      'f64'         — upcast factors and sum in float64 (requires
                      jax_enable_x64).
    """
    w = wjq[None] if wjq.ndim == v.ndim - 1 else wjq
    if mode == "native":
        return jnp.sum(w * v * rhs)
    if mode == "compensated":
        return dot3_compensated(w, v, rhs)
    if mode == "f64":
        if jnp.zeros((), jnp.float64).dtype != jnp.float64:
            raise ValueError("rhstest_mode='f64' requires jax_enable_x64")
        w64 = w.astype(jnp.float64)
        return jnp.sum(w64 * v.astype(jnp.float64) * rhs.astype(jnp.float64))
    raise ValueError(f"unknown rhstest mode: {mode!r}")
