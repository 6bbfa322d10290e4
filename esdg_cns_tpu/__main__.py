"""Command-line entry point: ``python -m esdg_cns_tpu <command> ...``.

The reference configures every run by editing top-of-script globals
(N, K1D, BCTYPE, Re, ... — dg2D_CNS_cavity_optimized.jl:21-36) and has
no executable entry point at all.  Here each packaged workload is
reachable from the command line with typed flags, printing the same
diagnostics the reference's drivers print (entropy balance ``rhstest``,
accepted/rejected step counts, error norms vs exact solutions) and
optionally writing npz / VTU output for post-processing.

Commands
--------
- ``info``               platform / devices / dtype summary
- ``list``               available workloads and their knobs
- ``run WORKLOAD ...``   run one workload; common flags:
  ``--n --k1d --t-end --dtype f32|f64 --backend cpu|gpu --out PREFIX``

Workloads mirror the reference drivers (see docs/migration.md):
``euler-hex`` (dg3D_euler_hex.jl), ``cavity``
(dg2D_CNS_cavity_optimized.jl), ``cavity3d`` (3D extension),
``shocktube1d`` (dg1D_CNS_modalESDG.jl), ``shocktube2d``
(dg2D_CNS_modalESDG.jl).
"""

from __future__ import annotations

import argparse
import sys
import time


def _setup_backend(args):
    import jax

    if args.backend:
        # must run before any computation (jax.config wins over the
        # JAX_PLATFORMS env var)
        jax.config.update("jax_platforms", args.backend)
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    return jnp.float64 if args.dtype == "f64" else jnp.float32


def _write_outputs(args, disc, q, extra=None):
    import numpy as np

    if not args.out:
        return
    from .utils import postprocess

    arrays = {f"q{i}": np.asarray(q[i]) for i in range(q.shape[0])}
    for i, xi in enumerate(disc.x):
        arrays[f"x{i}"] = np.asarray(xi)
    arrays.update(extra or {})
    postprocess.write_npz(args.out + ".npz", **arrays)
    print(f"wrote {args.out}.npz")
    if args.vtu and disc.dim >= 2:
        fields = {"rho": np.asarray(q[0]),
                  "speed2": np.asarray(
                      postprocess.velocity_magnitude_squared(q))}
        postprocess.write_vtu(args.out + ".vtu", disc, fields)
        print(f"wrote {args.out}.vtu")


def _print_adaptive_stats(stats):
    print(f"steps accepted/rejected: {int(stats['n_accepted'])}/"
          f"{int(stats['n_rejected'])}, final dt = {float(stats['dt']):.3e}")
    print(f"rhstest = {float(stats['rhstest']):.6e}, "
          f"rhstest_visc = {float(stats['rhstest_visc']):.6e}")


def run_euler_hex(args):
    import jax
    import jax.numpy as jnp

    from .presets import euler_hex_3d
    from .solvers import make_euler_rhs
    from .timestepping import lsrk45

    dtype = _setup_backend(args)
    disc, q0 = euler_hex_3d(n=args.n, k1d=args.k1d, curved=args.curved,
                            dtype=dtype)
    _, aux = jax.jit(make_euler_rhs(disc, dissipation=False,
                                    flux_diff_impl="auto"))(q0)
    print(f"N={args.n} K={disc.num_elements} curved={args.curved}: "
          f"rhstest (dissipation off) = {float(aux['rhstest']):.3e}")

    rhs = make_euler_rhs(disc, dissipation=True, flux_diff_impl="auto",
                         compute_rhstest=False)
    cn = (args.n + 1) * (args.n + 2) * 3 / 2
    dt = min(0.5 * (2.0 / args.k1d) / cn, args.t_end)
    nsteps = max(int(round(args.t_end / dt)), 1)
    dt = args.t_end / nsteps
    run = jax.jit(lambda q: lsrk45(rhs, q, jnp.asarray(dt, q0.dtype),
                                   nsteps)[0])
    qf = jax.block_until_ready(run(q0))  # compile + warm up
    # median of 3 reps: an indicative number — bench.py is the
    # measurement of record
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        qf = jax.block_until_ready(run(q0))
        times.append(time.perf_counter() - t0)
    el = sorted(times)[len(times) // 2]
    dof = 5 * disc.np_ * disc.num_elements
    print(f"{nsteps} LSRK45 steps to T={args.t_end} in {el:.3f}s -> "
          f"{dof * 5 * nsteps / el / 1e9:.3f} GDOF*stage/s "
          f"(median of 3; indicative — use bench.py for measurement)")
    _write_outputs(args, disc, qf)


def _run_cavity(args, three_d: bool):
    import jax

    from .solvers import make_cns_rhs_affine
    from .timestepping import dopri45

    dtype = _setup_backend(args)
    if three_d:
        from .presets import lid_driven_cavity_3d as preset
    else:
        from .presets import lid_driven_cavity as preset
    disc, q0, bc, p = preset(n=args.n, k1d=args.k1d, bctype=args.bctype,
                             re=args.re, dtype=dtype)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=args.re, bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True)
    cn = (args.n + 1) * (args.n + 2) / 2 * (3.0 if three_d else 1.0)
    dt0 = min(0.5 * (2.0 / args.k1d) / cn, 2.0 / (cn * args.k1d ** 2))
    qf, stats = jax.jit(
        lambda q: dopri45(rhs, q, args.t_end, dt0, err_tol=args.err_tol)
    )(q0)
    import numpy as np

    vel = np.asarray(qf[1:disc.dim + 1] / qf[0])
    print(f"BCTYPE={args.bctype} N={args.n} K={disc.num_elements} "
          f"Re={args.re} T={args.t_end}")
    _print_adaptive_stats(stats)
    print(f"max speed = {np.sqrt((vel ** 2).sum(0)).max():.4f}")
    _write_outputs(args, disc, qf)


def run_cavity(args):
    _run_cavity(args, three_d=False)


def run_cavity3d(args):
    _run_cavity(args, three_d=True)


def _run_shocktube(args, dim: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .solvers import make_cns_rhs
    from .timestepping import dopri45, ssprk33

    dtype = _setup_backend(args)
    if dim == 1:
        from .presets import becker_shocktube_1d

        disc, q0, bc, shock = becker_shocktube_1d(n=args.n, k=args.k1d,
                                                  dtype=dtype)
    else:
        from .presets import becker_shocktube_2d

        disc, q0, bc, shock = becker_shocktube_2d(n=args.n, k1d=args.k1d,
                                                  dtype=dtype)
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (args.n + 1) * (args.n + 2) / 2
    k1 = args.k1d
    if args.stepper == "ssprk33":
        dt = 2.0 / (cn * k1 * k1)
        ns = max(int(np.ceil(args.t_end / dt)), 1)
        qf, _ = jax.jit(lambda q: ssprk33(rhs, q, args.t_end / ns, ns))(q0)
        print(f"N={args.n} K={disc.num_elements} T={args.t_end} "
              f"({ns} SSPRK33 steps)")
    else:
        dt0 = min(0.5 * (2.0 / k1) / cn, 2.0 / (cn * k1 * k1))
        qf, stats = jax.jit(
            lambda q: dopri45(rhs, q, args.t_end, dt0, err_tol=args.err_tol)
        )(q0)
        print(f"N={args.n} K={disc.num_elements} T={args.t_end}")
        print(f"steps accepted/rejected: {int(stats['n_accepted'])}/"
              f"{int(stats['n_rejected'])}")

    # errors vs the exact Becker traveling wave, at quadrature points
    # (reference norm definitions: dg1D_CNS_modalESDG.jl:497-512)
    uq = np.asarray(jnp.einsum("ij,fjk->fik", disc.vq, qf,
                               precision=jax.lax.Precision.HIGHEST))
    u1d = shock.conservative(np.asarray(disc.xq[0]).ravel(), args.t_end)
    sh = uq.shape[1:]
    if dim == 1:
        uex = [u1d[0].reshape(sh), u1d[1].reshape(sh), u1d[2].reshape(sh)]
        comp = [0, 1, 2]
    else:
        uex = [u1d[0].reshape(sh), u1d[1].reshape(sh),
               np.zeros(sh), u1d[2].reshape(sh)]
        comp = [0, 1, 3]
    # reference normalizations (dg1D_CNS_modalESDG.jl:497-512): L1/L2
    # divide by the NUMERICAL solution's norm, Linf by the exact's
    w = np.asarray(disc.wjq)
    l1 = sum(np.sum(w * np.abs(uq[f] - uex[f]))
             / np.sum(w * np.abs(uq[f])) for f in comp)
    l2 = sum(np.sqrt(np.sum(w * (uq[f] - uex[f]) ** 2))
             / np.sqrt(np.sum(w * uq[f] ** 2)) for f in comp)
    linf = sum(np.abs(uq[f] - uex[f]).max()
               / np.abs(uex[f]).max() for f in comp)
    print(f"L1 error is {l1:.6e}")
    print(f"L2 error is {l2:.6e}")
    print(f"Linf error is {linf:.6e}")
    _write_outputs(args, disc, qf)


def run_shocktube1d(args):
    _run_shocktube(args, dim=1)


def run_shocktube2d(args):
    _run_shocktube(args, dim=2)


WORKLOADS = {
    "euler-hex": (run_euler_hex,
                  "3D periodic Euler, EC smoke test + timed LSRK45 "
                  "(ref dg3D_euler_hex.jl)"),
    "cavity": (run_cavity,
               "2D CNS lid-driven cavity, adaptive DOPRI45 "
               "(ref dg2D_CNS_cavity_optimized.jl)"),
    "cavity3d": (run_cavity3d,
                 "3D CNS lid-driven cavity (beyond reference)"),
    "shocktube1d": (run_shocktube1d,
                    "1D CNS Becker shocktube + exact-solution errors "
                    "(ref dg1D_CNS_modalESDG.jl)"),
    "shocktube2d": (run_shocktube2d,
                    "2D CNS Becker shocktube + exact-solution errors "
                    "(ref dg2D_CNS_modalESDG.jl)"),
}


def cmd_info(args):
    _setup_backend(args)
    import jax

    devs = jax.devices()
    print(f"jax {jax.__version__}")
    print(f"backend: {devs[0].platform} ({len(devs)} device(s))")
    print(f"x64 enabled: {jax.config.jax_enable_x64}")


def cmd_list(_args):
    width = max(len(k) for k in WORKLOADS)
    for name, (_fn, desc) in WORKLOADS.items():
        print(f"  {name:<{width}}  {desc}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m esdg_cns_tpu",
        description="Entropy-stable DG for Euler/Navier-Stokes",
    )
    sub = p.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--backend", choices=["cpu", "gpu"],
                        default=None,
                        help="force a jax platform (default: session's)")
    common.add_argument("--dtype", choices=["f32", "f64"], default="f32")

    sub.add_parser("info", parents=[common],
                   help="platform / device summary")
    sub.add_parser("list", parents=[common], help="list workloads")

    r = sub.add_parser("run", parents=[common], help="run a workload")
    r.add_argument("workload", choices=sorted(WORKLOADS))
    r.add_argument("--n", type=int, default=3, help="polynomial degree")
    r.add_argument("--k1d", type=int, default=8,
                   help="elements per direction (K for shocktube1d)")
    r.add_argument("--t-end", type=float, default=0.1)
    r.add_argument("--re", type=float, default=1000.0)
    r.add_argument("--bctype", default="isothermal",
                   choices=["adiabatic", "isothermal", "slip"])
    r.add_argument("--stepper", default="dopri45",
                   choices=["dopri45", "ssprk33"],
                   help="shocktube stepper (cavity is always dopri45)")
    r.add_argument("--err-tol", type=float, default=1e-5)
    r.add_argument("--curved", action="store_true",
                   help="euler-hex: warped periodic mesh")
    r.add_argument("--out", default=None,
                   help="output prefix: writes PREFIX.npz (+ .vtu)")
    r.add_argument("--vtu", action="store_true",
                   help="also write a VTU file with --out")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.command == "info":
        cmd_info(args)
    elif args.command == "list":
        cmd_list(args)
    else:
        WORKLOADS[args.workload][0](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
