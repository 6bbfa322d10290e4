"""Wall-BC convergence study: sweep N x bctype x dissipation flags x Re
on the regularized-lid cavity, boundary-weighted velocity L2 error.

Parity workload: reference
examples/CompressibleNS/dg2D_CNS_convergence_test.jl:848-852 (the full
nested sweep; writes err_arr.txt — here errors go to wall_bc_errors.json).

Default scope is the reference's full grid: N=1..4, K1D=32, all four
dissipation combinations, Re in {100, 1000}, adiabatic + isothermal
walls, T=1.  Override with ORDERS / K1D / BCTYPES / RES / DISSIPATION /
T / OUT.
"""

import os
import time

from common import env_float, env_int

from esdg_cns_tpu.verification import wall_bc_convergence_study

_DISSIPATION_CASES = {
    "all": ((False, False), (True, False), (False, True), (True, True)),
    "both": ((False, False), (True, True)),
    "on": ((True, True),),
    "off": ((False, False),),
}


def main():
    t0 = time.time()
    orders = tuple(
        int(s) for s in os.environ.get("ORDERS", "1,2,3,4").split(",")
    )
    bctypes = tuple(
        os.environ.get("BCTYPES", "adiabatic,isothermal").split(",")
    )
    res_list = tuple(
        float(s) for s in os.environ.get("RES", "100,1000").split(",")
    )
    res = wall_bc_convergence_study(
        orders=orders,
        k1d=env_int("K1D", 32),
        bctypes=bctypes,
        reynolds=res_list,
        dissipation_cases=_DISSIPATION_CASES[
            os.environ.get("DISSIPATION", "all")
        ],
        t_end=env_float("T", 1.0),
        output_path=os.environ.get("OUT", "wall_bc_errors.json"),
        verbose=True,
    )
    for (n, re, bt, inv_d, visc_d), err in sorted(res.items()):
        print(f"N={n} Re={re:g} {bt} dissipation=({inv_d},{visc_d}): "
              f"boundary L2 error = {err:.6e}")
    print(f"[{time.time() - t0:.0f}s total]")


if __name__ == "__main__":
    main()
