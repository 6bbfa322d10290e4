"""chip_smoke.py's double-float and multi-device phases at tiny sizes
on the host CPU (8 virtual devices, tests/conftest.py)."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402


def test_phase_eft_exact_backend():
    assert chip_smoke.phase_eft(n=1, k1d=2)["eft_exact"]


def test_phase_eft_inexact_backend_refuses(monkeypatch):
    from esdg_cns_tpu.utils import df64

    def broken():
        raise RuntimeError("contracted into FMA")

    monkeypatch.setattr(df64, "verify_eft", broken)
    monkeypatch.setattr(df64, "_EFT_FAILURES", {})
    assert chip_smoke.phase_eft(n=1, k1d=2) == {"eft_exact": False}


def test_phase_sharded_tiny():
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    errs = chip_smoke.phase_sharded(ndev=4, n=2, euler_k1d=2, cav_k1d=4,
                                    ens_k1d=2, steps=2, cavity_t_end=2e-2)
    assert len(errs) == 5
    assert all(e <= chip_smoke.TOL_SHARDED for e in errs.values())
