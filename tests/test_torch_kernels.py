"""The port's kernel module (opticomlib_tpu_torch.ops.kernels) against the
JAX package's Pallas kernels (interpret mode on the CPU).

On the CPU each wrapper computes its plain version; tests/test_torch_cuda.py
holds the Hopper kernels to those plain versions on a card.  Tolerances:
2e-5 as in tests/test_pallas.py (float32 cos/sin and products); histogram
counts exact.  ``cmul`` is held tighter where the test says so: the Pallas
kernel, ``A * B`` on the CPU and the CUDA kernel's written-down rounding
(``fma(ar, br, -(ai*bi))``, ``fma(ar, bi, ai*br)``) differ by one rounding
of one product, 2^-24 of ``|ar*br| + |ai*bi|``.
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


@pytest.mark.parametrize("shape,broadcast", [
    ((4096,), False), ((5001,), False), ((2, 5000), True), ((2, 5001), True),
    ((2, 5000), False), ((3, 2, 257), True), ((1,), False)])
def test_cmul_wrapper_matches_pallas(shape, broadcast):
    """Both shapes the wrapper takes, odd lengths included, through the
    wrapper on CPU tensors, row by row against the Pallas kernel (interpret
    mode): within one rounding of one product of the exact result."""
    A = _field(shape, 9)
    B = _field(shape[-1:] if broadcast else shape, 10)
    C = kernels.cmul(torch.from_numpy(A), torch.from_numpy(B))
    assert C.dtype == torch.complex64 and tuple(C.shape) == shape
    assert kernels.LAUNCHES["cmul"] == 0  # CPU: the plain version
    rows_a = A.reshape(-1, shape[-1])
    rows_b = np.broadcast_to(B, shape).reshape(-1, shape[-1])
    rows_c = C.numpy().reshape(-1, shape[-1])
    for a, b, c in zip(rows_a, rows_b, rows_c):
        ore, oim = (np.asarray(o) for o in pk.cmul(
            a.real.copy(), a.imag.copy(), b.real.copy(), b.imag.copy()))
        bound = 2.0**-23 * (np.abs(a.real * b.real) + np.abs(a.imag * b.imag)
                            + np.abs(a.real * b.imag)
                            + np.abs(a.imag * b.real)) + 1e-30
        assert np.all(np.abs(c - (ore + 1j * oim)) <= bound)
        exact = a.astype(np.complex128) * b.astype(np.complex128)
        assert np.all(np.abs(c - exact) <= bound)


def test_cmul_written_rounding_is_within_one_product_rounding():
    """The CUDA kernel's arithmetic, emulated in NumPy (each product and
    each fma rounded to float32 once), against ``cmul_ref`` on the CPU."""
    A, B = _field(5000, 11), _field(5000, 12)
    ar, ai, br, bi = (x.astype(np.float64) for x in (A.real, A.imag, B.real,
                                                     B.imag))
    f32 = lambda x: x.astype(np.float32).astype(np.float64)
    # a float64 product of two float32 is exact, so one cast is one rounding
    re = f32(ar * br - f32(ai * bi))
    im = f32(ar * bi + f32(ai * br))
    ref = kernels.cmul_ref(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    bound = 2.0**-23 * (np.abs(ar * br) + np.abs(ai * bi) + np.abs(ar * bi)
                        + np.abs(ai * br))
    assert np.all(np.abs(ref - (re + 1j * im)) <= bound)


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


def _pallas_rows(y, ny):
    """The row-batched histogram through the Pallas kernel (interpret mode):
    row c as the pairs (c, y[c, k])."""
    nrow, n = y.shape
    t = np.repeat(np.arange(nrow), n).astype(np.float32)
    return np.asarray(pk.histogram2d(t, y.reshape(-1).astype(np.float32),
                                     nrow, ny))


@pytest.mark.parametrize("nrow,n,ny", [(1, 4096, 4096), (3, 5000, 64),
                                       (16, 1000, 256), (2, 0, 16)])
def test_histogram_rows_matches_pallas(nrow, n, ny):
    """The wrapper (on the CPU: its plain version) against the Pallas
    kernel, masked -1 and out-of-range samples included, one row, and empty
    rows; counts exact."""
    rng = np.random.default_rng(13)
    y = rng.integers(-2, ny + 2, (nrow, n)).astype(np.int32)
    y[:, ::5] = -1                                     # masked samples
    got = kernels.histogram_rows(torch.from_numpy(y), ny)
    assert got.dtype == torch.float32 and got.shape == (nrow, ny)
    if n:
        np.testing.assert_array_equal(got.numpy(), _pallas_rows(y, ny))
    else:
        assert not got.any()
    for c in range(nrow):   # a row is the 1-row table of the 2-D entry
        yc = torch.from_numpy(y[c].copy())
        assert torch.equal(got[c], kernels.histogram2d(
            torch.zeros_like(yc), yc, 1, ny)[0])
    assert kernels.LAUNCHES["histogram2d"] == 0


@pytest.mark.parametrize("n,nt,ny", [(6000, 256, 256), (6000, 16, 8192),
                                     (0, 4, 4), (100, 1, 1)])
def test_histogram2d_wrapper_matches_pallas(n, nt, ny):
    """The 2-D entry at the shapes of the eye-density render and of the
    range estimator's table, empty input and a one-bin table."""
    rng = np.random.default_rng(14)
    t = rng.integers(-1, nt + 1, n).astype(np.int32)
    y = rng.integers(-1, ny + 1, n).astype(np.int32)
    got = kernels.histogram2d(torch.from_numpy(t), torch.from_numpy(y), nt, ny)
    assert got.dtype == torch.float32 and got.shape == (nt, ny)
    if n:
        np.testing.assert_array_equal(got.numpy(), np.asarray(pk.histogram2d(
            t.astype(np.float32), y.astype(np.float32), nt, ny)))
    else:
        assert not got.any()
    ok = (t >= 0) & (t < nt) & (y >= 0) & (y < ny)
    assert got.sum().item() == ok.sum()


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
    y2 = y.reshape(3, 100).contiguous()
    assert torch.equal(kernels.histogram_rows(y2, 5),
                       kernels.histogram_rows_ref(y2, 5))
    x = A.real.contiguous()
    assert torch.equal(kernels.adc_quantize(x, -1.0, 1.0, 4),
                       kernels.adc_quantize_ref(x, -1.0, 1.0, 4))
    assert torch.equal(
        kernels.adc_quantize(x, -1.0, 1.0, 4, stochastic=True, seed=2),
        kernels.adc_quantize_ref(x, -1.0, 1.0, 4, stochastic=True, seed=2))
    lo, hi = x.min(), x.max()
    assert torch.equal(kernels.adc_quantize_link(x, lo, hi, 6),
                       kernels.adc_quantize_link_ref(x, lo, hi, 6))
    h = x[:17].contiguous()
    assert torch.equal(kernels.fir_filter(x, h), kernels.fir_filter_ref(x, h))
    grid = [torch.linspace(0.5, -0.5, 9)[:8].contiguous()] * 4
    coeff = (x[:50].contiguous(), x[50:100].contiguous(),
             x[100:150].contiguous())
    for got, want in zip(kernels.fbg_rk4(*coeff, 3.0, *grid, 8),
                         kernels.fbg_rk4_ref(*coeff, 3.0, *grid, 8)):
        assert torch.equal(got, want)
    assert kernels.LAUNCHES == {"nl_halfstep": 0, "cmul": 0,
                                "histogram2d": 0, "adc_quantize": 0,
                                "fir_filter": 0, "fbg_rk4": 0}
    assert "triton" not in sys.modules


@pytest.mark.parametrize("call", [
    lambda: kernels.nl_halfstep(torch.zeros(4), 0.1),              # dtype
    lambda: kernels.cmul(torch.zeros(4, dtype=torch.complex64),
                         torch.zeros(3, dtype=torch.complex64)),   # shape
    lambda: kernels.cmul(torch.zeros((2, 8), dtype=torch.complex64)[:, ::2],
                         torch.zeros(4, dtype=torch.complex64)),   # layout
    lambda: kernels.cmul(torch.zeros(4, dtype=torch.complex64),
                         torch.zeros(4, dtype=torch.complex128)),  # dtype
    lambda: kernels.cmul(torch.zeros(4, dtype=torch.complex64),
                         torch.zeros(4)),                          # dtype
    lambda: kernels.cmul(torch.zeros((2, 4), dtype=torch.complex64),
                         torch.zeros((1, 4), dtype=torch.complex64)),  # 2-D
    lambda: kernels.cmul(torch.zeros((2, 4), dtype=torch.complex64),
                         torch.zeros(2, dtype=torch.complex64)),   # axis
    lambda: kernels.cmul(torch.zeros(4, dtype=torch.complex64),
                         torch.zeros(4, dtype=torch.complex64,
                                     device="meta")),              # devices
    lambda: kernels.histogram2d(torch.zeros(4, dtype=torch.int64),
                                torch.zeros(4, dtype=torch.int64), 1, 4),
    lambda: kernels.histogram2d(torch.zeros(4, dtype=torch.int32),
                                torch.zeros(5, dtype=torch.int32), 1, 4),
    lambda: kernels.histogram2d(torch.zeros(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32), 0, 4),
    lambda: kernels.histogram_rows(torch.zeros(4, dtype=torch.int32), 4),
    lambda: kernels.histogram_rows(torch.zeros((2, 4)), 4),        # dtype
    lambda: kernels.histogram_rows(torch.zeros((2, 4), dtype=torch.int32),
                                   0),                             # bins
    lambda: kernels.histogram_rows(torch.zeros((2, 8), dtype=torch.int32)
                                   [:, ::2], 4),                   # layout
    lambda: kernels.histogram_rows(torch.zeros(
        (kernels.HIST_MAX_ROWS + 1, 1), dtype=torch.int32), 4),    # rows
    lambda: kernels.adc_quantize(torch.zeros(4, dtype=torch.float64),
                                 0.0, 1.0, 4),                     # dtype
    lambda: kernels.adc_quantize(torch.zeros(4), 0.0, 1.0, 0),     # nbits
    lambda: kernels.adc_quantize_link(torch.zeros(4), torch.zeros(1),
                                      torch.ones(()), 8),          # 0-d
    lambda: kernels.adc_quantize_link(torch.zeros(4), torch.zeros(()),
                                      torch.ones((), dtype=torch.float64),
                                      8),                          # dtype
    lambda: kernels.adc_quantize_link(torch.zeros(4), torch.zeros(()),
                                      torch.ones(()), 17),         # bits
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
