"""Becker-shocktube errors at the REFERENCE DRIVER'S exact configuration.

The reference 1D CNS driver (dg1D_CNS_modalESDG.jl:83-103) runs the
Mach-3 Becker viscous shocktube at N=4, K=128, T=0.1, mu=0.1, Pr=3/4,
lambda=+2/3 mu, and prints L1/L2/Linf errors against the closed-form
traveling wave with its own normalizations (:497-512 — L1/L2 divided by
the NUMERICAL solution's norm, Linf by the exact's).  The paper behind
the reference (arXiv:2011.11089) publishes convergence tables for this
workload.

This script runs OUR solver at that exact configuration (and a K-sweep
around it for the convergence rates), with the reference's norm
definitions, in float64, and records the table to
results/paper_anchor_r05.json.

HONESTY NOTE: the paper PDF is not reachable from this environment
(zero egress) and its tables are not vendored anywhere in the reference
repo, so this artifact does NOT assert equality against the paper's
printed digits.  What it provides is the strongest available external
anchor short of that: errors against an ANALYTIC exact solution at the
reference's own configuration and norm conventions, pinned against
regression by tests/test_paper_anchor.py, and directly comparable to
the paper's table by any reader with access to it.

Usage: python examples/paper_anchor.py   [OUT=results/paper_anchor_r05.json]
"""

import json
import os
import sys

os.environ.setdefault("JAX_ENABLE_X64", "1")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import common  # noqa: F401  (repo path + compile cache)

import jax

# f64 accuracy study: CPU by default, PLATFORM=gpu for the card
jax.config.update("jax_platforms", os.environ.get("PLATFORM", "cpu"))
# the config call is the reliable x64 switch (jax may already be
# imported, so the env var can be read too late; f32 here leaves the
# tol=1e-11 controller chasing noise and gives anti-convergent errors)
jax.config.update("jax_enable_x64", True)

import numpy as np

from esdg_cns_tpu.verification import becker_shocktube_errors


def main():
    out = os.environ.get("OUT", os.path.join(HERE, "..", "results",
                                             "paper_anchor_r05.json"))
    # time-integration tolerance must sit far below the smallest spatial
    # error (the reference drives its embedded-RK estimator at
    # TOL=1e-16, dg1D_CNS_modalESDG.jl:81); 1e-7 was measured to floor
    # the N=3/N=4 K=128 errors at ~1e-5
    err_tol = float(os.environ.get("ERR_TOL", 1e-11))
    ks = tuple(int(x) for x in
               os.environ.get("KS", "32,64,128").split(","))
    rows = []
    # the reference configuration is (N=4, K=128); the K-sweep at each N
    # exposes the convergence rates the paper tabulates
    for n in (2, 3, 4):
        for k in ks:
            errs = becker_shocktube_errors(n=n, k=k, t_end=0.1,
                                           err_tol=err_tol)
            rows.append({"n": n, "k": k, **errs})
            print(f"N={n} K={k:4d}: L1 {errs['l1']:.6e}  "
                  f"L2 {errs['l2']:.6e}  Linf {errs['linf']:.6e}",
                  flush=True)
    # observed orders between successive K at fixed N
    for n in (2, 3, 4):
        sub = [r for r in rows if r["n"] == n]
        for a, b in zip(sub, sub[1:]):
            b["l2_rate"] = float(np.log2(a["l2"] / b["l2"]))
        print(f"N={n} L2 rates: "
              + ", ".join(f"{r['l2_rate']:.2f}" for r in sub[1:]))

    payload = {
        "description": "Becker shocktube errors at the reference driver "
                       "configuration (dg1D_CNS_modalESDG.jl:83-103, "
                       "norms :497-512), f64; see module docstring for "
                       "the anchoring semantics",
        "config": {"mach": 3.0, "mu": 0.1, "pr": 0.75, "t_end": 0.1,
                   "stepper": "dopri45", "err_tol": err_tol,
                   "reference_row": {"n": 4, "k": 128}},
        "rows": rows,
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(f"-> {out}")


if __name__ == "__main__":
    main()
