"""Does the DP/ensemble axis actually pay on hardware?

The reference runs its parameter sweeps as serial re-solves
(dg2D_CNS_convergence_test.jl:848-852).  The replacement here
vmaps the Reynolds axis into ONE program (parallel/ensemble.py,
verification.wall_bc_reynolds_ensemble).  This measures both on the
real chip at identical physics: B adaptive cavity solves to T, as
(a) a python loop over one jitted single-member solve (re traced, so
the loop re-uses one executable — the best serial baseline), and
(b) one vmapped batch call.

Small per-member problems underutilize the chip (few elements, little
lane parallelism); batching fills it, so the vmapped sweep should
approach the per-call cost of ONE member.  Records wall times,
speedup, and the max |error difference| between the two executions of
the same members (they run the same math; differences are
reduction-order roundoff).

    python examples/ensemble_throughput.py

Env: N (2), K1D (8), T (0.1), B (8), OUT
(results/ensemble_throughput.json).
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_ENABLE_X64", "0")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import jax
import jax.numpy as jnp
import numpy as np


from common import env_float, env_int

from esdg_cns_tpu.parallel.ensemble import ensemble
from esdg_cns_tpu.presets import lid_driven_cavity
from esdg_cns_tpu.solvers import make_cns_rhs
from esdg_cns_tpu.timestepping import dopri45
from esdg_cns_tpu.verification import (
    boundary_velocity_error,
    regularized_lid,
)


def main():
    n = env_int("N", 2)
    k1d = env_int("K1D", 8)
    t_end = env_float("T", 0.1)
    b = env_int("B", 8)
    out_path = os.environ.get("OUT", "results/ensemble_throughput.json")

    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d,
                                        lid_profile=regularized_lid,
                                        bctype="adiabatic")
    lid_mask = bc.regions[0].mask
    wall_mask = bc.regions[1].mask
    prof = jnp.asarray(regularized_lid(np.asarray(disc.xf[0])),
                       dtype=disc.wq.dtype)
    cn = (n + 1) * (n + 2) / 2
    dt0 = min(0.25 * (2.0 / k1d) / cn, 2.0 / (cn * k1d ** 2))

    def single(re):
        rhs = make_cns_rhs(
            disc, mu=1.0 / re, pr=p["pr"], re=re, bc=bc,
            inviscid_dissipation=True, viscous_dissipation=True,
            compute_rhstest=False,
        )
        qf, _ = dopri45(rhs, q0, t_end, dt0, err_tol=1e-5)
        return boundary_velocity_error(disc, qf, lid_mask, wall_mask, prof)

    res = jnp.geomspace(50.0, 800.0, b).astype(disc.wq.dtype)
    single_j = jax.jit(single)
    batched = ensemble(single)   # jit(vmap(single))

    # warm both executables (compiles excluded from timing)
    e0 = single_j(res[0]).block_until_ready()
    eb = batched(res).block_until_ready()

    def timeit(fn, reps=3):
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    t_serial = timeit(
        lambda: [single_j(r).block_until_ready() for r in res])
    t_batch = timeit(lambda: batched(res).block_until_ready())
    t_one = timeit(lambda: single_j(res[0]).block_until_ready())

    errs_serial = np.array([float(single_j(r)) for r in res])
    errs_batch = np.asarray(batched(res))
    agree = float(np.max(np.abs(errs_serial - errs_batch)
                         / np.maximum(np.abs(errs_serial), 1e-30)))

    out = {
        "config": {"n": n, "k1d": k1d, "t_end": t_end, "batch": b,
                   "platform": jax.devices()[0].platform,
                   "reynolds": [float(r) for r in res]},
        "t_serial_s": t_serial,
        "t_batch_s": t_batch,
        "t_single_member_s": t_one,
        "speedup": t_serial / t_batch,
        "batch_vs_one_member": t_batch / t_one,
        "errors": errs_batch.tolist(),
        "serial_batch_rel_agreement": agree,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"serial {b}x: {t_serial:.3f} s   batched: {t_batch:.3f} s   "
          f"one member: {t_one:.3f} s")
    print(f"speedup {out['speedup']:.2f}x   batch costs "
          f"{out['batch_vs_one_member']:.2f}x one member   "
          f"agreement {agree:.2e}")
    print(f"-> {out_path}")


if __name__ == "__main__":
    main()
