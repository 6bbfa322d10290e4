"""CLI entry point (python -m esdg_cns_tpu): parsing + tiny end-to-end
runs of each command path, in-process (conftest pins the CPU backend).

The reference has no executable entry point (runs are configured by
editing script globals, dg2D_CNS_cavity_optimized.jl:21-36); the CLI is
the typed-config equivalent exposed as a console command.
"""

import numpy as np
import pytest

from esdg_cns_tpu.__main__ import WORKLOADS, build_parser, main


def test_parser_rejects_unknown_workload():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["run", "nope"])


def test_info_and_list(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "backend:" in out and "jax" in out
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    for name in WORKLOADS:
        assert name in out


def test_run_cavity_tiny(capsys, tmp_path):
    out = str(tmp_path / "cav")
    assert main(["run", "cavity", "--n", "1", "--k1d", "2",
                 "--t-end", "5e-3", "--err-tol", "1e-4",
                 "--out", out, "--vtu"]) == 0
    text = capsys.readouterr().out
    assert "rhstest" in text and "max speed" in text
    data = np.load(out + ".npz")
    assert data["q0"].shape == data["x0"].shape  # rho on nodal layout
    assert np.isfinite(data["q0"]).all()
    assert (tmp_path / "cav.vtu").exists()


def test_run_shocktube1d_tiny(capsys):
    assert main(["run", "shocktube1d", "--n", "2", "--k1d", "8",
                 "--t-end", "1e-3", "--stepper", "ssprk33"]) == 0
    text = capsys.readouterr().out
    # exact-solution error report, small on the resolved Becker profile
    l2 = float(text.split("L2 error is")[1].split()[0])
    assert l2 < 0.1
    assert "Linf error is" in text


def test_run_euler_hex_tiny(capsys):
    assert main(["run", "euler-hex", "--n", "1", "--k1d", "2",
                 "--t-end", "1e-3"]) == 0
    text = capsys.readouterr().out
    # EC smoke: dissipation-off entropy residual at f32 roundoff scale
    rhstest = abs(float(text.split("rhstest (dissipation off) =")[1]
                        .split()[0]))
    assert rhstest < 1e-4
    assert "GDOF*stage/s" in text


@pytest.mark.parametrize("backend,accepted", [
    ("cpu", True), ("gpu", True), ("cuda", False), ("metal", False)])
def test_backend_choices(backend, accepted):
    """--backend names exactly the platforms the program runs on: the
    host CPU (tests, references) and the GPU."""
    argv = ["run", "cavity", "--backend", backend]
    if accepted:
        assert build_parser().parse_args(argv).backend == backend
    else:
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
