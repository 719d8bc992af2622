"""The port's kernel module (opticomlib_tpu_torch.ops.kernels) against the
JAX package's Pallas kernels (interpret mode on the CPU).

On the CPU each wrapper computes its plain version; tests/test_torch_cuda.py
holds the Hopper kernels to those plain versions on a card.  Tolerances:
2e-5 as in tests/test_pallas.py (float32 cos/sin and products); histogram
counts exact.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from opticomlib_tpu.ops import pallas_kernels as pk
from opticomlib_tpu_torch.ops import kernels

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _field(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


@pytest.fixture(autouse=True)
def _zero_launches():
    kernels.reset_launches()
    yield


@pytest.mark.parametrize("n", [4096, 5000])
def test_nl_halfstep_ref_matches_pallas(n):
    A = _field(n, 1)
    c = np.float32(0.37)
    bre, bim, hre, him = (np.asarray(o) for o in pk.nl_halfstep(
        A.real.copy(), A.imag.copy(), c))
    B, H = kernels.nl_halfstep_ref(torch.from_numpy(A), c)
    np.testing.assert_allclose(B.numpy(), bre + 1j * bim, **TOL)
    np.testing.assert_allclose(H.numpy(), hre + 1j * him, **TOL)


@pytest.mark.parametrize("n", [4096, 5000])
def test_cmul_ref_matches_pallas(n):
    A, B = _field(n, 2), _field(n, 3)
    ore, oim = (np.asarray(o) for o in pk.cmul(
        A.real.copy(), A.imag.copy(), B.real.copy(), B.imag.copy()))
    C = kernels.cmul_ref(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(C.numpy(), ore + 1j * oim, **TOL)


def test_cmul_broadcast_matches_pallas_per_row():
    n = 5000
    A, B = _field((2, n), 4), _field(n, 5)
    C = kernels.cmul(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    for r in range(2):
        ore, oim = (np.asarray(o) for o in pk.cmul(
            A[r].real.copy(), A[r].imag.copy(), B.real.copy(),
            B.imag.copy()))
        np.testing.assert_allclose(C[r], ore + 1j * oim, **TOL)


@pytest.mark.parametrize("n,nt,ny", [(4096, 1, 4096), (5000, 8, 64)])
def test_histogram2d_ref_matches_pallas(n, nt, ny):
    rng = np.random.default_rng(6)
    t = rng.integers(-1, nt + 1, n).astype(np.int32)   # some out of range
    y = rng.integers(-2, ny + 2, n).astype(np.int32)
    expect = np.asarray(pk.histogram2d(t.astype(np.float32),
                                       y.astype(np.float32), nt, ny))
    got = kernels.histogram2d_ref(torch.from_numpy(t), torch.from_numpy(y),
                                  nt, ny)
    assert got.dtype == torch.float32 and got.shape == (nt, ny)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_wrappers_take_plain_path_on_cpu():
    A, B = torch.from_numpy(_field(300, 7)), torch.from_numpy(_field(300, 8))
    Bk, Hk = kernels.nl_halfstep(A, 0.2)
    Br, Hr = kernels.nl_halfstep_ref(A, 0.2)
    assert torch.equal(Bk, Br) and torch.equal(Hk, Hr)
    assert torch.equal(kernels.cmul(A, B), kernels.cmul_ref(A, B))
    t = torch.zeros(300, dtype=torch.int32)
    y = torch.arange(300, dtype=torch.int32) % 7 - 1
    assert torch.equal(kernels.histogram2d(t, y, 1, 5),
                       kernels.histogram2d_ref(t, y, 1, 5))
    assert kernels.LAUNCHES == {"nl_halfstep": 0, "cmul": 0,
                                "histogram2d": 0}
    assert "triton" not in sys.modules


@pytest.mark.parametrize("call", [
    lambda: kernels.nl_halfstep(torch.zeros(4), 0.1),              # dtype
    lambda: kernels.cmul(torch.zeros(4, dtype=torch.complex64),
                         torch.zeros(3, dtype=torch.complex64)),   # shape
    lambda: kernels.cmul(torch.zeros((2, 8), dtype=torch.complex64)[:, ::2],
                         torch.zeros(4, dtype=torch.complex64)),   # layout
    lambda: kernels.histogram2d(torch.zeros(4, dtype=torch.int64),
                                torch.zeros(4, dtype=torch.int64), 1, 4),
    lambda: kernels.histogram2d(torch.zeros(4, dtype=torch.int32),
                                torch.zeros(5, dtype=torch.int32), 1, 4),
])
def test_wrappers_reject_bad_input(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_kernels_module_imports_without_triton():
    code = ("import sys; import opticomlib_tpu_torch.ops.kernels; "
            "assert 'triton' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
