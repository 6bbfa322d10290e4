"""Smoke test of the ES-DG main path on the GPU, in one process.

    python chip_smoke.py             # one GPU: phases (a)-(e)
    python chip_smoke.py --chips 4   # four GPUs: the sharded paths (f) only

Phases:
  (a) the card (nvidia-smi name and power limit) and the JAX devices;
      anything but a GPU platform is refused, with no CPU fallback;
  (b) the main path at bench size through the user entry points (bench
      runners, ``SimConfig``/``build_problem``/``run_simulation`` and
      the CLI): 3D Euler hex N=3 K=32^3, 2D CNS cavity N=3 K=2*128^2,
      3D CNS cavity N=3 K=16^3 — a few LSRK45 steps each plus a short
      adaptive DOPRI45 run of each cavity; every state must be finite
      float32;
  (c) each problem's RHS against an independent plain reference at
      N=3: Euler 'lines' vs dense all-pairs 'xla' (K=16^3), affine CNS
      vs the generic ``make_cns_rhs`` (bench size), and every problem
      in f32 on the card vs float64 on the host CPU at k1d=4;
  (d) the entropy acceptance check (``rhstest``, dissipation off) in
      native float64 on the card: curved N=3 Euler hex (K=8^3) and the
      affine CNS cavity;
  (e) ``utils.df64.verify_eft`` on the card; if it fails, the
      double-float builders must refuse to build;
  (f) with ``--chips 4`` only: pjit element sharding of the Euler
      'lines' path, the shard_map + ring ppermute halo path of the CNS
      cavity (RHS, and DOPRI45 in float64 with equal accept counts) and
      the 2D ("ens", "e") mesh, each against one device.

Any failed phase exits non-zero without the final line.  The last line
of standard output is the JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Tolerances (relative max-norm, max|a - b| / max|b|).
#  * Any f32 evaluation against another one that associates the operators
#    differently (lines vs dense pairs, composed vs generic operators) or
#    against float64 on the host: measured on the host CPU at N=3, each
#    f32 path lies 1.5e-5 (Euler) to 8e-5 (2D cavity) from float64, flat
#    in k1d from 4 to 48 — the state's own f32 rounding amplified by the
#    entropy-variable maps (logs, 1/p) and the cancelling flux sums, not
#    an error that grows with the mesh.  2e-4 leaves a factor 2.5 for the
#    card's own summation order and FMA contraction.
TOL_F32 = 2e-4
#  * sharded vs one device: the same per-element arithmetic; only the
#    partitioner's fusion and the global reductions may reorder sums.
TOL_SHARDED = 1e-5
#  * native float64 entropy residual: the CPU tests' bound
#    (tests/test_euler_rhs.py, tests/test_viscous.py).
TOL_RHSTEST_F64 = 1e-11
TOL_VISC_IBP_F64 = 1e-10


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def check(name, err, tol):
    log(f"  {name}: rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:.0e}")


def check_state(name, q, dtype="float32"):
    import numpy as np

    q = np.asarray(q)
    if str(q.dtype) != dtype or not np.isfinite(q).all():
        raise AssertionError(f"{name}: dtype {q.dtype}, finite "
                             f"{bool(np.isfinite(q).all())}")


def perturbed(q0, seed=0, scale=0.01):
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    return q0 * (1.0 + scale * jnp.asarray(rng.standard_normal(q0.shape),
                                            q0.dtype))


# ---------------------------------------------------------------- (a)
def phase_device():
    import jax

    from esdg_cns_tpu.utils.device_info import card_lines, jax_device

    for line in card_lines() or ["nvidia-smi: no card found"]:
        log(f"card: {line}")
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    return jax_device()


# ---------------------------------------------------------------- (b)
def _cli(argv):
    """Run the CLI in-process; returns (stdout text, seconds)."""
    from esdg_cns_tpu.__main__ import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"CLI {argv} returned {rc}")
    return buf.getvalue(), dt


def _check_npz(name, path):
    import numpy as np

    with np.load(path) as f:
        for key in f.files:
            if key.startswith("q"):
                check_state(f"{name} {key}", f[key])


def phase_main_path(n=3, euler_k1d=32, cav_k1d=128, cav3d_k1d=16, steps=5,
                    reps=3, cavity_t_end=2e-3):
    import jax
    import jax.numpy as jnp

    import bench
    from esdg_cns_tpu.config import SimConfig, build_problem, run_simulation
    from esdg_cns_tpu.presets import euler_hex_3d

    out = {}
    runs = (("euler_hex", bench.bench_euler_hex, euler_k1d),
            ("cns_cavity", bench.bench_cns_cavity, cav_k1d),
            ("cns_cavity_3d", bench.bench_cns_cavity_3d, cav3d_k1d))
    for name, runner, k1d in runs:
        t0 = time.perf_counter()
        r = runner(n=n, k1d=k1d, steps=steps, reps=reps)
        wall = time.perf_counter() - t0
        if not r["finite"] or r["dtype"] != "float32":
            raise AssertionError(f"bench {name}: {r}")
        log(f"  bench {name}: N={n} k1d={k1d} DOF={r['dof']} "
            f"{r['s_per_step'] * 1e3:.3f} ms/LSRK45 step after compile "
            f"({r['value']:.4e} DOF*stage/s, {wall:.1f} s incl. compile)")
        out[name] = r

    # SimConfig -> build_problem -> run_simulation (Euler hex, lines)
    cn = (n + 1) * (n + 2) / 2 * 3.0
    dt = 0.5 * (2.0 / euler_k1d) / cn
    cfg = SimConfig(equation="euler", elem_type="hex", n=n, k1d=euler_k1d,
                    flux_diff_impl="lines", stepper="lsrk45", dt=dt,
                    t_end=steps * dt, dtype=jnp.float32)
    _, q0 = euler_hex_3d(n=n, k1d=euler_k1d, dtype=jnp.float32)
    t0 = time.perf_counter()
    disc, rhs = build_problem(cfg)
    qf, aux = jax.block_until_ready(run_simulation(cfg, q0, rhs))
    check_state("SimConfig euler", qf)
    log(f"  SimConfig euler hex: {steps} LSRK45 steps in "
        f"{time.perf_counter() - t0:.1f} s incl. compile, "
        f"rhstest {float(aux['rhstest'][-1]):+.3e}")

    # the CLI: EC smoke + timed LSRK45, and both adaptive cavities
    with tempfile.TemporaryDirectory() as tmp:
        for workload, k1d, t_end in (
                ("euler-hex", euler_k1d, steps * dt),
                ("cavity", cav_k1d, cavity_t_end),
                ("cavity3d", cav3d_k1d, cavity_t_end)):
            prefix = os.path.join(tmp, workload)
            text, wall = _cli(["run", workload, "--n", n, "--k1d", k1d,
                               "--t-end", t_end, "--out", prefix])
            _check_npz(f"CLI {workload}", prefix + ".npz")
            log(f"  CLI run {workload} (N={n} k1d={k1d} T={t_end:.3g}): "
                f"{wall:.1f} s incl. compile")
            for line in text.strip().splitlines():
                if not line.startswith("wrote"):
                    log(f"    | {line}")
    dev = jax.devices()[0]
    stats = dev.memory_stats() if hasattr(dev, "memory_stats") else None
    if stats and "peak_bytes_in_use" in stats:
        log(f"  peak device memory: {stats['peak_bytes_in_use'] / 2**30:.2f}"
            " GiB")
    return out


# ---------------------------------------------------------------- (c)
def _cavity_rhs_pair(n, k1d, three_d, dtype, xla_fd=False):
    """(q, affine rhs, generic rhs) on a perturbed cavity state."""
    from esdg_cns_tpu.presets import lid_driven_cavity, lid_driven_cavity_3d
    from esdg_cns_tpu.solvers import make_cns_rhs, make_cns_rhs_affine

    preset = lid_driven_cavity_3d if three_d else lid_driven_cavity
    disc, q0, bc, p = preset(n=n, k1d=k1d, dtype=dtype)
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True,
              compute_rhstest=False)
    fd = "xla" if xla_fd else "auto"
    return (perturbed(q0), make_cns_rhs_affine(disc, flux_diff_impl=fd,
                                               **kw),
            make_cns_rhs(disc, **kw))


def _euler_rhs(n, k1d, dtype, impl):
    from esdg_cns_tpu.presets import euler_hex_3d
    from esdg_cns_tpu.solvers import make_euler_rhs

    disc, q0 = euler_hex_3d(n=n, k1d=k1d, dtype=dtype)
    return perturbed(q0), make_euler_rhs(disc, dissipation=True,
                                         flux_diff_impl=impl,
                                         compute_rhstest=False)


def _dq(rhs, q):
    import jax

    return jax.block_until_ready(jax.jit(rhs)(q)[0])


def phase_compare_card(n=3, euler_k1d=16, cav_k1d=128, cav3d_k1d=16):
    """f32 on the card: each fast path against its plain reference."""
    import jax.numpy as jnp

    errs = {}
    t0 = time.perf_counter()
    q, lines = _euler_rhs(n, euler_k1d, jnp.float32, "lines")
    _, dense = _euler_rhs(n, euler_k1d, jnp.float32, "xla")
    errs["euler lines vs dense xla"] = rel_err(_dq(lines, q), _dq(dense, q))
    for name, k1d, three_d in (("cavity", cav_k1d, False),
                               ("cavity3d", cav3d_k1d, True)):
        q, affine, generic = _cavity_rhs_pair(n, k1d, three_d, jnp.float32,
                                              xla_fd=not three_d)
        errs[f"{name} affine vs generic"] = rel_err(_dq(affine, q),
                                                    _dq(generic, q))
    for key, err in errs.items():
        check(key, err, TOL_F32)
    log(f"  ({time.perf_counter() - t0:.1f} s incl. compile)")
    return errs


def small_problems(n, k1d, dtype):
    """(name, q, rhs) for the three problems at a small size."""
    q, rhs = _euler_rhs(n, k1d, dtype, "lines")
    yield "euler hex lines", q, rhs
    for name, three_d in (("cavity affine", False),
                          ("cavity3d affine", True)):
        q, affine, _ = _cavity_rhs_pair(n, k1d, three_d, dtype,
                                        xla_fd=not three_d)
        yield name, q, affine


def card_small_rhs(n=3, k1d=4):
    """f32 RHS of each small problem on the card, as host arrays."""
    import jax.numpy as jnp
    import numpy as np

    return {name: (np.asarray(q), np.asarray(_dq(rhs, q)))
            for name, q, rhs in small_problems(n, k1d, jnp.float32)}


def phase_compare_host_f64(card, n=3, k1d=4):
    """The card's f32 RHS against float64 on the host CPU, from the same
    (f32-rounded) state.  Needs jax_enable_x64."""
    import jax
    import jax.numpy as jnp

    errs = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for name, _, rhs in small_problems(n, k1d, jnp.float64):
            q32, dq32 = card[name]
            ref = _dq(rhs, jnp.asarray(q32, jnp.float64))
            errs[f"{name} card f32 vs host f64"] = rel_err(dq32, ref)
    for key, err in errs.items():
        check(key, err, TOL_F32)
    return errs


# ---------------------------------------------------------------- (d)
def phase_rhstest_f64(n=3, euler_k1d=8, cav_k1d=16):
    """Native float64 entropy acceptance (dissipation off).  Needs
    jax_enable_x64."""
    import jax
    import jax.numpy as jnp

    from esdg_cns_tpu.presets import euler_hex_3d, lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs

    disc, q0 = euler_hex_3d(n=n, k1d=euler_k1d, curved=True,
                            dtype=jnp.float64)
    assert not disc.affine
    _, aux = jax.jit(make_euler_rhs(disc, dissipation=False,
                                    flux_diff_impl="lines"))(perturbed(q0))
    rt_euler = float(aux["rhstest"])
    log(f"  curved euler hex N={n} k1d={euler_k1d} f64: rhstest "
        f"{rt_euler:+.3e} (tol {TOL_RHSTEST_F64:.0e})")
    if not abs(rt_euler) <= TOL_RHSTEST_F64:
        raise AssertionError(f"euler f64 rhstest {rt_euler}")

    # adiabatic walls: no boundary entropy flux, so the inviscid part is
    # entropy conservative (rhstest = -viscous production) and the
    # viscous integration by parts is exact
    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=cav_k1d, bctype="adiabatic",
                                        dtype=jnp.float64)
    rhs = make_cns_rhs_affine(disc, mu=p["mu"], pr=p["pr"], re=p["re"],
                              bc=bc)
    _, aux = jax.jit(rhs)(perturbed(q0))
    rt, visc = float(aux["rhstest"]), float(aux["rhstest_visc"])
    ibp = float(aux["rhstest_visc_total"])
    tol = TOL_VISC_IBP_F64 * max(visc, 1.0)
    log(f"  cavity affine N={n} k1d={cav_k1d} f64: rhstest {rt:+.3e}, "
        f"viscous production {visc:+.3e}, |rhstest + production| "
        f"{abs(rt + visc):.3e}, viscous IBP residual {abs(ibp):.3e} "
        f"(tol {tol:.0e})")
    if not (abs(rt + visc) <= tol and abs(ibp) <= tol and visc > 0):
        raise AssertionError("cavity f64 entropy balance")
    return {"euler": rt_euler, "cavity": rt + visc}


# ---------------------------------------------------------------- (e)
def phase_eft(n=2, k1d=4):
    import jax
    import jax.numpy as jnp

    from esdg_cns_tpu.presets import euler_hex_3d
    from esdg_cns_tpu.solvers.euler_df64 import make_euler_rhs_df64
    from esdg_cns_tpu.utils.df64 import verify_eft

    disc, q0, host = euler_hex_3d(n=n, k1d=k1d, dtype=jnp.float32,
                                  return_host=True)
    try:
        err = verify_eft()
    except RuntimeError as e:
        log(f"  verify_eft FAILED on {jax.default_backend()}: {e}")
        try:
            make_euler_rhs_df64(disc, host, dissipation=False)
        except RuntimeError as guard:
            log(f"  df64 builder refuses to build: {guard}")
            return {"eft_exact": False}
        raise AssertionError("inexact EFTs but the df64 builder built")
    log(f"  verify_eft: rel err {err:.3e} (exact double-float arithmetic)")
    _, aux = jax.jit(make_euler_rhs_df64(disc, host, dissipation=False))(q0)
    rt = float(aux["rhstest"])
    log(f"  df64 euler hex N={n} k1d={k1d}: rhstest {rt:+.3e} (tol 1e-10)")
    if not abs(rt) <= 1e-10:
        raise AssertionError(f"df64 rhstest {rt}")
    return {"eft_exact": True, "verify_eft": err}


# ---------------------------------------------------------------- (f)
def phase_sharded(ndev=4, n=3, euler_k1d=16, cav_k1d=128, ens_k1d=8,
                  steps=3, cavity_t_end=1e-3):
    """The multi-device paths against one device (f32; the DOPRI45 step
    counts in float64, which needs jax_enable_x64)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from esdg_cns_tpu.parallel import launch, shard_discretization
    from esdg_cns_tpu.parallel.sharding import make_sharded_cns_rhs_affine
    from esdg_cns_tpu.presets import euler_hex_3d, lid_driven_cavity
    from esdg_cns_tpu.solvers import make_cns_rhs_affine, make_euler_rhs
    from esdg_cns_tpu.timestepping import dopri45, lsrk45

    devices = jax.devices()[:ndev]
    if len(devices) < ndev:
        raise RuntimeError(f"need {ndev} devices, have {len(jax.devices())}")
    mesh = launch.make_device_mesh(devices=devices)
    errs = {}

    # pjit element sharding of the Euler lines path
    disc, q0 = euler_hex_3d(n=n, k1d=euler_k1d, dtype=jnp.float32)
    q = perturbed(q0)
    kw = dict(dissipation=True, flux_diff_impl="lines",
              compute_rhstest=False)
    dt = jnp.float32(1e-4)
    ref_rhs = make_euler_rhs(disc, **kw)
    disc_s, q_s = shard_discretization(mesh, "e", disc, q)
    rhs_s = make_euler_rhs(disc_s, **kw)
    t0 = time.perf_counter()
    errs["pjit euler lines rhs"] = rel_err(_dq(rhs_s, q_s), _dq(ref_rhs, q))
    run = lambda r: jax.jit(lambda x: lsrk45(r, x, dt, steps)[0])
    errs["pjit euler lines lsrk45"] = rel_err(run(rhs_s)(q_s), run(ref_rhs)(q))
    log(f"  pjit euler N={n} k1d={euler_k1d} over {ndev} devices "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")

    # shard_map + ring ppermute halo: CNS cavity, RHS (f32) and DOPRI45.
    # The accept/reject decisions hang on a global error norm over every
    # DOF; in f32 the sharded partial sums reorder that reduction by
    # ~1e-5 relative, enough to move a step boundary, so the step counts
    # are compared in native float64 (jax_enable_x64), where the reorder
    # is ~1e-13.
    def cavity(dtype):
        disc, q0, bc, p = lid_driven_cavity(n=n, k1d=cav_k1d, dtype=dtype)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                  inviscid_dissipation=True, viscous_dissipation=True,
                  compute_rhstest=False)
        return (q0, make_cns_rhs_affine(disc, **kw),
                make_sharded_cns_rhs_affine(mesh, disc, **kw))

    q0, ref_rhs, rhs_sm = cavity(jnp.float32)
    q = perturbed(q0)
    t0 = time.perf_counter()
    errs["shard_map cavity rhs"] = rel_err(_dq(rhs_sm, q), _dq(ref_rhs, q))
    q0, ref_rhs, rhs_sm = cavity(jnp.float64)
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.5 * (2.0 / cav_k1d) / cn, 2.0 / (cn * cav_k1d ** 2))
    solve = lambda r: jax.jit(lambda x: dopri45(r, x, cavity_t_end, dt0,
                                                err_tol=1e-5))
    qf_sm, st_sm = solve(rhs_sm)(q0)
    qf_ref, st_ref = solve(ref_rhs)(q0)
    acc = (int(st_sm["n_accepted"]), int(st_ref["n_accepted"]))
    rej = (int(st_sm["n_rejected"]), int(st_ref["n_rejected"]))
    log(f"  shard_map cavity N={n} k1d={cav_k1d}: f64 DOPRI45 accepted "
        f"{acc[0]} vs {acc[1]}, rejected {rej[0]} vs {rej[1]} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    if acc[0] != acc[1] or rej[0] != rej[1]:
        raise AssertionError(f"DOPRI45 step counts differ: {acc} {rej}")
    errs["shard_map cavity f64 dopri45"] = rel_err(qf_sm, qf_ref)

    # 2D ("ens", "e") mesh: a vmapped batch x element sharding
    disc, q0 = euler_hex_3d(n=n, k1d=ens_k1d, dtype=jnp.float32)
    qb = jnp.stack([perturbed(q0, seed=0), perturbed(q0, seed=1)])
    kw = dict(dissipation=True, flux_diff_impl="lines",
              compute_rhstest=False)
    ref = jax.jit(jax.vmap(lambda x: make_euler_rhs(disc, **kw)(x)[0]))(qb)
    mesh2 = launch.make_device_mesh(shape=(2, ndev // 2),
                                    axis_names=("ens", "e"), devices=devices)
    disc_s, _ = shard_discretization(mesh2, "e", disc)
    qb_s = jax.device_put(qb, NamedSharding(mesh2, P("ens", None, None, "e")))
    out = jax.jit(jax.vmap(lambda x: make_euler_rhs(disc_s, **kw)(x)[0]))(qb_s)
    errs["2D mesh ens x e euler rhs"] = rel_err(np.asarray(out), ref)

    for key, err in errs.items():
        check(key, err, TOL_SHARDED)
    return errs


# ---------------------------------------------------------------- main
def _phase(label, fn, *args, **kw):
    log(f"phase {label}")
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {label}: ok ({time.perf_counter() - t0:.1f} s)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the multi-device phase (f)")
    args = p.parse_args(argv)

    import jax

    from esdg_cns_tpu.utils.compile_cache import enable_compile_cache

    t_start = time.perf_counter()
    try:
        device = _phase("(a) device", phase_device)
        if device["platform"] != "gpu":
            log(f"refused: JAX platform is {device['platform']!r}, not gpu")
            return 2
        log(f"compile cache: {enable_compile_cache()}")
        if args.chips == 4:
            jax.config.update("jax_enable_x64", True)
            _phase("(f) sharded paths", phase_sharded, ndev=4)
        else:
            _phase("(b) main path", phase_main_path)
            _phase("(c) card references", phase_compare_card)
            card = card_small_rhs()
            _phase("(e) double-float EFTs", phase_eft)
            jax.config.update("jax_enable_x64", True)
            _phase("(c) host float64 references", phase_compare_host_f64,
                   card)
            _phase("(d) native float64 rhstest", phase_rhstest_f64)
    except Exception:
        traceback.print_exc()
        log("FAILED")
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    # the host CPU backend must come up beside the GPU for the float64
    # reference of phase (c)
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.exit(main())
