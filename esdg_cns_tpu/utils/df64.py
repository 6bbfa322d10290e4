"""Double-float (df64) arithmetic: emulated float64 from f32 pairs.

Every correctly rounded f32 op is all error-free transformations need:
a value is carried as an unevaluated (hi, lo) pair with ~2^-48 effective precision (~3.6e-15
relative), built from Dekker/Knuth two_sum / two_prod primitives (the
same building blocks as utils.compensated, extended here to a full
arithmetic: +, -, *, /, sqrt, exp, log and the transcendental chains the
entropy-stable RHS needs).

This backs the ``dtype_mode='df64'`` verification RHS
(solvers.euler_df64): the reference attains machine-zero entropy
residuals in native Float64 (dg2D_euler_tri.jl:177-183); the df64 RHS
reproduces that from f32 state arithmetic, closing the gap that is f32
flux-level roundoff (not diagnostic accumulation).  A compiler that
contracts mul+add into FMA breaks the transformations; verify_eft
probes the backend and require_exact_eft refuses it.

Representation: plain (hi, lo) tuples of same-shaped jnp arrays, with
|lo| <= ulp(hi)/2 after every renormalizing op.  Works in f32 on the device
and in f64 on CPU (giving ~quad precision, used by the unit tests to check
the f32 path against true f64).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .compensated import _fast_renorm, _two_prod, _two_sum

# -----------------------------------------------------------------------------
# constructors
# -----------------------------------------------------------------------------


def df_const(value, dtype=jnp.float32):
    """Split a host float into an (hi, lo) pair of the target dtype."""
    hi = np.asarray(value, np.float64).astype(dtype)
    lo = (np.asarray(value, np.float64) - hi.astype(np.float64)).astype(dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_split_array(value, dtype=jnp.float32):
    """Split a host f64 numpy array into df pairs (for operators)."""
    v = np.asarray(value, np.float64)
    hi = v.astype(dtype)
    lo = (v - hi.astype(np.float64)).astype(dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def df(x):
    """Promote an f32 array to a df pair (exact)."""
    return x, jnp.zeros_like(x)


def df_to_f64(a):
    """(hi, lo) -> numpy f64 (test/diagnostic helper)."""
    return np.asarray(a[0], np.float64) + np.asarray(a[1], np.float64)


# -----------------------------------------------------------------------------
# ring ops
# -----------------------------------------------------------------------------


def df_add(a, b):
    s, e = _two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return _fast_renorm(s, e)


def df_neg(a):
    return -a[0], -a[1]


def df_sub(a, b):
    return df_add(a, df_neg(b))


def df_add_f(a, s):
    hi, e = _two_sum(a[0], s)
    return _fast_renorm(hi, e + a[1])


def df_mul(a, b):
    p, e = _two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return _fast_renorm(p, e)


def df_mul_f(a, s):
    """Multiply by a plain (same-dtype) array/scalar s."""
    p, e = _two_prod(a[0], s)
    return _fast_renorm(p, e + a[1] * s)


def df_mul_c(a, value: float):
    """Multiply by a host f64 constant, split exactly into a df pair.

    Use this (NOT df_mul_f) for any constant that is inexact in the
    compute dtype — e.g. gamma-1 = 0.4, whose f32 rounding alone costs
    1.5e-8 relative error (measured: it capped the df64 RHS at f32
    accuracy before this distinction was made).
    """
    return df_mul(a, df_const(value, a[0].dtype))


def df_add_c(a, value: float):
    """Add a host f64 constant via an exact df split (see df_mul_c)."""
    ch, cl = df_const(value, a[0].dtype)
    s, e = _two_sum(a[0], ch)
    return _fast_renorm(s, e + (a[1] + cl))


def df_sqr(a):
    p, e = _two_prod(a[0], a[0])
    e = e + 2.0 * (a[0] * a[1])
    return _fast_renorm(p, e)


def df_div(a, b):
    """Full double-float division (two Newton corrections)."""
    q1 = a[0] / b[0]
    r = df_sub(a, df_mul_f(b, q1))
    q2 = r[0] / b[0]
    r = df_sub(r, df_mul_f(b, q2))
    q3 = r[0] / b[0]
    hi, lo = _fast_renorm(*_two_sum(q1, q2))
    return _fast_renorm(*_two_sum(hi, lo + q3))


def df_recip(b):
    one = jnp.ones_like(b[0])
    return df_div((one, jnp.zeros_like(one)), b)


def df_sqrt(a):
    """sqrt via one Karp-Markstein correction of the f32 estimate.

    r0 = sqrt_f32(a) has ~eps_32 relative error; r = r0 + (a - r0^2) /
    (2 r0) squares it to ~eps_32^2 < eps_df.
    """
    r0 = jnp.sqrt(a[0])
    d = df_sub(a, df_sqr((r0, jnp.zeros_like(r0))))
    corr = d[0] / (2.0 * r0)
    hi, lo = _two_sum(r0, corr)
    return _fast_renorm(hi, lo + d[1] / (2.0 * r0))


# -----------------------------------------------------------------------------
# transcendentals
# -----------------------------------------------------------------------------

_LN2 = 0.6931471805599453094172321214581766


def df_exp(a):
    """exp in double-float: ln2 argument reduction + Taylor in df.

    |r| <= ln2/2 after reduction; 14 Taylor terms reach < 2^-52
    truncation, below the df roundoff floor.
    """
    import math

    dtype = a[0].dtype
    ln2 = df_const(_LN2, dtype)
    m = jnp.round(a[0] / jnp.asarray(_LN2, dtype))
    r = df_sub(a, df_mul_f(ln2, m))
    # Horner: sum_{n=0..N} r^n / n!
    n_terms = 14
    coeffs = np.array(
        [1.0 / float(math.factorial(n)) for n in range(n_terms, -1, -1)]
    )
    acc = df_horner(r, coeffs)
    # exact power-of-two scale: jnp.exp2 is an approximation on some
    # backends (measured 2^29 off by 256 on XLA:CPU f32); ldexp is exact
    scale = jnp.ldexp(jnp.ones_like(a[0]), m.astype(jnp.int32))
    return acc[0] * scale, acc[1] * scale


def df_horner(x, coeffs_np):
    """sum_n coeffs[n] x^(N-n) via a scanned df Horner recurrence.

    ``coeffs_np``: host f64 coefficients, highest order first.  A scan
    keeps the traced graph O(1) in the term count — unrolled df Horner
    chains at every transcendental call site stalled XLA compiles.
    """
    import jax

    dtype = x[0].dtype
    c_hi, c_lo = df_split_array(np.asarray(coeffs_np, np.float64), dtype)
    zero = jnp.zeros_like(x[0])
    acc0 = (c_hi[0] + zero, c_lo[0] + zero)

    def step(acc, c):
        return df_add(df_mul(acc, x), (c[0] + zero, c[1] + zero)), None

    acc, _ = jax.lax.scan(step, acc0, (c_hi[1:], c_lo[1:]))
    return acc


def df_log(a):
    """log via two Newton iterations on y -> y + (x e^{-y} - 1).

    y0 = log_f32 has ~1e-7 relative error; each iteration squares it, so
    one reaches ~1e-14 and the second polishes to the df floor.
    """
    y = df(jnp.log(a[0]))
    for _ in range(2):
        ey = df_exp(df_neg(y))
        y = df_add(y, df_add_f(df_mul(a, ey), -1.0))
    return y


def df_pow(a, p: float):
    """a**p for a > 0 with static exponent.

    Half-integer exponents (the gamma=1.4 constitutive chains: 2.5, 3.5)
    use exact integer powers x sqrt — cheaper and slightly more accurate
    than the general exp(p log a) fallback.
    """
    # snap to (half-)integer exponents within f64 roundoff of the ratio
    # arithmetic that produced them (e.g. -1.4/0.4 = -3.4999999999999996)
    if abs(2.0 * p - round(2.0 * p)) < 1e-12 * max(1.0, abs(p)):
        p = round(2.0 * p) / 2.0
    if float(p) == int(p):
        n = int(p)
        if n == 0:
            return df(jnp.ones_like(a[0]))
        out = None
        base = a if n > 0 else df_recip(a)
        for _ in range(abs(n)):
            out = base if out is None else df_mul(out, base)
        return out
    if float(2 * p) == int(2 * p):
        ipart = int(np.floor(p))
        rest = df_sqrt(a)
        if ipart == 0:
            return rest
        return df_mul(df_pow(a, ipart), rest)
    return df_exp(df_mul_f(df_log(a), jnp.asarray(p, a[0].dtype)))


# -----------------------------------------------------------------------------
# linear algebra
# -----------------------------------------------------------------------------


def df_apply(a_df, x_df):
    """[M, N] df operator @ [..., N, K] df stacked fields.

    Compensated contraction: the N-loop accumulates in double-float (a
    matmul rounds every partial sum and cannot reach df accuracy).
    Runs as a lax.scan so the traced graph (and compile time) stays
    O(1) in N.
    """
    import jax

    ah, al = a_df
    xh, xl = x_df
    m, n = ah.shape
    xh_t = jnp.moveaxis(xh, -2, 0)                     # [N, ..., K]
    xl_t = jnp.moveaxis(xl, -2, 0)
    out_shape = xh.shape[:-2] + (m,) + xh.shape[-1:]

    def step(acc, inp):
        colh, coll, vh, vl = inp                       # [M], [M], [...,K]
        term = df_mul(
            (colh[:, None], coll[:, None]),
            (vh[..., None, :], vl[..., None, :]),
        )                                              # [..., M, K]
        return df_add(acc, term), None

    acc0 = (jnp.zeros(out_shape, xh.dtype), jnp.zeros(out_shape, xh.dtype))
    acc, _ = jax.lax.scan(step, acc0, (ah.T, al.T, xh_t, xl_t))
    return acc


def df_sum_tree(a):
    """Pairwise-tree reduction of a df array over ALL axes -> df scalar."""
    hi = a[0].ravel()
    lo = a[1].ravel()
    n = hi.shape[0]
    n_pow2 = 1 << max(n - 1, 1).bit_length() if n & (n - 1) else n
    if n_pow2 != n:
        pad = jnp.zeros((n_pow2 - n,), hi.dtype)
        hi = jnp.concatenate([hi, pad])
        lo = jnp.concatenate([lo, pad])
    while hi.shape[0] > 1:
        m = hi.shape[0] // 2
        hi, lo = df_add((hi[:m], lo[:m]), (hi[m:], lo[m:]))
    return hi[0], lo[0]


def df_where(mask, a, b):
    return jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1])


def verify_eft(rtol: float = 1e-13) -> float:
    """On-device check that jit-compiled EFT chains keep df accuracy.

    Compilers can silently destroy error-free transformations — x86 FMA
    contraction turns the renormalization ``fl(p)+e`` into
    ``fma(a,b,e) = fl(p+2e)``, double-counting the compensation
    (measured on XLA:CPU; fixed there by ``--xla_cpu_max_isa=AVX``).
    This probe runs a jitted df multiply-accumulate chain on the current
    default backend against a host-f64 reference and raises if the
    relative error exceeds ``rtol`` (the df floor is ~4e-15).  Call it
    before trusting df64 results on a new backend/compiler version.
    Returns the measured relative error.
    """
    import jax

    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((32, 16))
    x64 = rng.standard_normal((3, 16, 64))
    a = df_split_array(a64)
    x = df_split_array(x64)

    got = df_to_f64(jax.jit(df_apply)(a, x))
    want = np.einsum("mn,fnk->fmk", df_to_f64(a), df_to_f64(x))
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if err > rtol:
        raise RuntimeError(
            f"double-float arithmetic is NOT exact under jit on this "
            f"backend (rel err {err:.2e} > {rtol:.0e}); the compiler is "
            f"likely contracting mul+add into FMA — on XLA:CPU set "
            f"XLA_FLAGS=--xla_cpu_max_isa=AVX"
        )
    return err


_EFT_FAILURES = {}


def require_exact_eft(what: str) -> None:
    """Raise unless double-float arithmetic is exact on the default
    backend (``verify_eft``, probed once per backend and process).

    Builders of the double-float paths call this at build time, so a
    compiler that contracts mul+add into FMA makes them refuse to build
    instead of returning inexact numbers quietly.
    """
    import jax

    backend = jax.default_backend()
    if backend not in _EFT_FAILURES:
        try:
            verify_eft()
            _EFT_FAILURES[backend] = None
        except RuntimeError as e:
            _EFT_FAILURES[backend] = str(e)
    if _EFT_FAILURES[backend] is not None:
        raise RuntimeError(
            f"{what} needs exact double-float arithmetic, which the "
            f"{backend!r} backend does not give "
            f"({_EFT_FAILURES[backend]}); check the entropy balance in "
            f"native float64 instead (jax_enable_x64, a float64 state "
            f"and rhstest_mode='native')")
