"""chip_smoke.py's phases at tiny sizes on the host CPU, against the
same references the GPU run uses, and its refusal of a non-GPU
platform.  The card run itself is ``python chip_smoke.py`` (README)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _no_repo_cache(monkeypatch, tmp_path):
    # the CLI and bench enable the compile cache; keep it off the repo
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_non_gpu_platform(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert "refused" in out
    assert '"ok"' not in out


def test_phase_main_path_tiny():
    out = chip_smoke.phase_main_path(n=2, euler_k1d=2, cav_k1d=4,
                                     cav3d_k1d=2, steps=2, reps=2,
                                     cavity_t_end=1e-3)
    assert set(out) == {"euler_hex", "cns_cavity", "cns_cavity_3d"}
    for r in out.values():
        assert r["finite"] and r["dtype"] == "float32"


def test_phase_compare_card_tiny():
    errs = chip_smoke.phase_compare_card(n=3, euler_k1d=2, cav_k1d=3,
                                         cav3d_k1d=2)
    assert len(errs) == 3
    assert all(e <= chip_smoke.TOL_F32 for e in errs.values())


def test_phase_compare_host_f64_tiny():
    card = chip_smoke.card_small_rhs(n=2, k1d=2)
    assert {str(dq.dtype) for _, dq in card.values()} == {"float32"}
    errs = chip_smoke.phase_compare_host_f64(card, n=2, k1d=2)
    # f32 against f64 is a real difference, not a comparison with itself
    assert all(0.0 < e <= chip_smoke.TOL_F32 for e in errs.values())


def test_phase_rhstest_f64_tiny():
    out = chip_smoke.phase_rhstest_f64(n=2, euler_k1d=2, cav_k1d=3)
    assert abs(out["euler"]) <= chip_smoke.TOL_RHSTEST_F64
