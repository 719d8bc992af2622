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


@pytest.mark.parametrize("shape", [(4096,), (2, 4096), (5001,), (2, 4099),
                                   (1,)])
@pytest.mark.parametrize("two", [False, True])
def test_strang_kicks_ref_is_scale_then_two_kicks(shape, two):
    """The boundary pass's plain version is the scale, then
    ``nl_halfstep_ref`` once or twice (the second kick at the magnitudes
    after the first), bit for bit; the wrapper on the CPU writes it in
    place or into ``out`` and launches nothing."""
    s = kernels.spectral_scale(shape[-1])
    A = torch.from_numpy(_field(shape, 19, 1.0 / s))  # an unscaled inverse
    c1 = np.float32(0.37)
    c2 = np.float32(-0.21) if two else None
    want = kernels.nl_halfstep_ref(A * s, c1)[0]
    if two:
        want = kernels.nl_halfstep_ref(want, c2)[0]
    assert torch.equal(kernels.strang_kicks_ref(A, s, c1, c2), want)
    out = torch.empty_like(A)
    assert kernels.strang_kicks(A, s, c1, c2, out=out) is out
    assert torch.equal(out, want)
    assert kernels.strang_kicks(A, s, c1, c2) is A and torch.equal(A, want)
    assert kernels.LAUNCHES["strang_kicks"] == 0


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


@pytest.mark.parametrize("shape", [(4096,), (2, 4096), (5000,), (2, 5000),
                                   (4097,), (1,)])
def test_spectral_phase_ref_is_lin_factor_and_inverse_scale(shape):
    """The plain version is ``cmul(X, _lin_factor(phi, alpha, h))`` times the
    inverse FFT's 1/n, bit for bit, at a power-of-two length (a power of
    two scales exactly), and with nothing folded at any other length."""
    from opticomlib_tpu_torch.ops import ssfm
    n = shape[-1]
    X = torch.from_numpy(_field(shape, 15, 40.0))
    phi = torch.from_numpy(
        np.random.default_rng(16).normal(size=n).astype(np.float32) * 40)
    alpha, h = np.float32(0.046), np.float32(0.731)
    got = kernels.spectral_phase_ref(X, phi, ssfm._step_loss(alpha, h), h)
    want = kernels.cmul(X, ssfm._lin_factor(phi, alpha, h))
    s = kernels.spectral_scale(n)
    assert s == (1.0 / n if n & (n - 1) == 0 else 1.0)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want) * s)
    # and the folded inverse is the plain inverse, up to the CPU FFT's own
    # scaling pass
    norm = "forward" if s != 1 else "backward"
    torch.testing.assert_close(torch.fft.ifft(got, norm=norm),
                               torch.fft.ifft(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(4096,), (2, 5001), (1,)])
def test_cmul_max_ref_is_cmul_then_max_power(shape):
    """The product with its ``max(re^2 + im^2)`` is ``cmul`` then the
    solver's old ``max_power`` formula, bit for bit; a NaN anywhere makes
    the maximum NaN, as ``torch.max`` does."""
    A = torch.from_numpy(_field(shape, 17))
    H = torch.from_numpy(_field(shape, 18))
    C, m = kernels.cmul_max_ref(A, H)
    want = kernels.cmul(A, H)
    assert torch.equal(C, want)
    assert m.dtype == torch.float32 and m.ndim == 0
    assert torch.equal(m, torch.view_as_real(want).square().sum(-1).max())
    assert torch.equal(kernels.power_max(A),
                       torch.view_as_real(A).square().sum(-1).max())
    # the wrappers on the CPU: into out= and m=
    out, m0 = torch.empty_like(A), torch.empty(())
    C2, m2 = kernels.cmul_max(A, H, out=out, m=m0)
    assert C2 is out and m2 is m0 and torch.equal(C2, C)
    assert torch.equal(m2, m)
    A.view(-1)[-1] = complex("nan")
    assert torch.isnan(kernels.cmul_max(A, H)[1])
    assert torch.isnan(kernels.power_max(A))


def _pencil_consts(P: int, B: int) -> tuple:
    """``(W_f, W_i, tw_f, tw_i)`` of the last rank of a P-rank axis (both
    twiddles non-trivial for P > 1), as ``parallel.dfft`` builds them."""
    from opticomlib_tpu_torch.parallel.dfft import _transform_consts
    return _transform_consts(P, B, P - 1, torch.device("cpu"))


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("lead", [(), (3,), (3, 2)])
def test_pencil_dft_ref_is_the_composed_transform_steps(P, lead):
    """The DFT pass's plain version is the steps the pencil FFT composed
    before it, bit for bit: with the twiddle, the einsum into ``(..., k,
    c)``, ``cmul`` and the pack into ``(P, ..., C)``; without, the inverse's
    einsum.  Both are the DFT of float64 arithmetic to float32 round-off
    (C = 7, not a multiple of 4)."""
    C = 7
    B = P * C
    W_f, W_i, tw_f, _ = _pencil_consts(P, B)
    z = torch.from_numpy(_field((P,) + lead + (C,), 19))
    y = torch.einsum("kn,n...c->...kc", W_f, z).reshape(lead + (B,))
    y = kernels.cmul(y.contiguous(), tw_f)
    want = y.reshape(lead + (P, C)).movedim(-2, 0).contiguous()
    got = kernels.pencil_dft(z, W_f, tw_f)
    assert got.shape == (P,) + lead + (C,) and got.is_contiguous()
    assert torch.equal(got, want)
    got_i = kernels.pencil_dft(z, W_i)
    assert got_i.is_contiguous()
    assert torch.equal(got_i, torch.einsum("nk,k...c->n...c", W_i, z))
    zd = z.numpy().astype(np.complex128)
    twd = tw_f.numpy().astype(np.complex128).reshape(
        (P,) + (1,) * len(lead) + (C,))
    for W, tw, out in ((W_f, twd, got), (W_i, 1.0, got_i)):
        ref = np.einsum("kn,n...c->k...c", W.numpy().astype(np.complex128),
                        zd) * tw
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
    assert kernels.LAUNCHES["pencil"] == 0  # CPU: the plain version


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("lead", [(), (3,), (3, 2)])
def test_pencil_twiddle_pack_ref_is_cmul_then_pack(P, lead):
    """The inverse's twiddle-and-pack plain version is ``cmul`` by the
    twiddle and the pack of the last axis's P blocks to the front, bit for
    bit: ``out[p, ..., c] = u[..., p*C + c] * tw[p*C + c]``."""
    C = 7
    B = P * C
    tw_i = _pencil_consts(P, B)[3]
    u = torch.from_numpy(_field(lead + (B,), 20))
    want = kernels.cmul(u, tw_i).reshape(lead + (P, C)).movedim(
        -2, 0).contiguous()
    got = kernels.pencil_twiddle_pack(u, tw_i, P)
    assert got.shape == (P,) + lead + (C,) and got.is_contiguous()
    assert torch.equal(got, want)
    # the layout, block by block (the CPU's vector and scalar complex
    # products round apart, so to one rounding)
    for p in range(P):
        torch.testing.assert_close(got[p], u[..., p * C:(p + 1) * C]
                                   * tw_i[p * C:(p + 1) * C],
                                   rtol=2.0**-22, atol=0)
    assert kernels.LAUNCHES["pencil"] == 0


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
    X = A.clone()
    assert kernels.spectral_phase(X, x, 0.9, 0.25) is X
    assert torch.equal(X, kernels.spectral_phase_ref(A, x, 0.9, 0.25))
    C, m = kernels.cmul_max(A, B)
    Cr, mr = kernels.cmul_max_ref(A, B)
    assert torch.equal(C, Cr) and torch.equal(m, mr)
    assert torch.equal(kernels.power_max(A), kernels.power_max_ref(A))
    assert torch.equal(kernels.strang_kicks(A.clone(), 0.5, 0.2, -0.1),
                       kernels.strang_kicks_ref(A, 0.5, 0.2, -0.1))
    z, u, tw = A.reshape(2, 3, 50), A.reshape(3, 100), B[:100].contiguous()
    W = torch.tensor([[1, 1], [1, -1]], dtype=torch.complex64)
    assert torch.equal(kernels.pencil_dft(z, W, tw),
                       kernels.pencil_dft_ref(z, W, tw))
    assert torch.equal(kernels.pencil_dft(z, W), kernels.pencil_dft_ref(z, W))
    assert torch.equal(kernels.pencil_twiddle_pack(u, tw, 2),
                       kernels.pencil_twiddle_pack_ref(u, tw, 2))
    assert kernels.LAUNCHES == {"nl_halfstep": 0, "strang_kicks": 0,
                                "cmul": 0, "spectral_phase": 0,
                                "cmul_max": 0, "pencil": 0,
                                "histogram2d": 0, "adc_quantize": 0,
                                "fir_filter": 0, "fbg_rk4": 0}
    assert "triton" not in sys.modules


_EYE2 = torch.eye(2, dtype=torch.complex64)


@pytest.mark.parametrize("call", [
    lambda: kernels.nl_halfstep(torch.zeros(4), 0.1),              # dtype
    lambda: kernels.strang_kicks(torch.zeros(4), 1.0, 0.1),        # dtype
    lambda: kernels.strang_kicks(torch.zeros((2, 8), dtype=torch.complex64)
                                 [:, ::2], 1.0, 0.1),              # layout
    lambda: kernels.strang_kicks(torch.zeros(4, dtype=torch.complex64), 1.0,
                                 0.1, out=torch.zeros(
                                     5, dtype=torch.complex64)),   # out
    lambda: kernels.strang_kicks(torch.zeros(4, dtype=torch.complex64), 1.0,
                                 0.1, out=torch.zeros(
                                     4, dtype=torch.complex64,
                                     device="meta")),              # devices
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
    lambda: kernels.spectral_phase(torch.zeros(4, dtype=torch.complex128),
                                   torch.zeros(4), 1.0, 0.1),      # dtype
    lambda: kernels.spectral_phase(torch.zeros(4, dtype=torch.complex64),
                                   torch.zeros(4, dtype=torch.float64),
                                   1.0, 0.1),                      # dtype
    lambda: kernels.spectral_phase(torch.zeros(4, dtype=torch.complex64),
                                   torch.zeros(3), 1.0, 0.1),      # shape
    lambda: kernels.spectral_phase(torch.zeros((2, 4), dtype=torch.complex64),
                                   torch.zeros((2, 4)), 1.0, 0.1),  # 2-D
    lambda: kernels.spectral_phase(torch.zeros((2, 8), dtype=torch.complex64)
                                   [:, ::2], torch.zeros(4), 1.0,
                                   0.1),                           # layout
    lambda: kernels.spectral_phase(torch.zeros(4, dtype=torch.complex64),
                                   torch.zeros(4, device="meta"), 1.0,
                                   0.1),                           # devices
    lambda: kernels.cmul_max(torch.zeros(4, dtype=torch.complex64),
                             torch.zeros(4, dtype=torch.complex128)),  # dtype
    lambda: kernels.cmul_max(torch.zeros((2, 4), dtype=torch.complex64),
                             torch.zeros(4, dtype=torch.complex64)),  # shape
    lambda: kernels.cmul_max(torch.zeros(0, dtype=torch.complex64),
                             torch.zeros(0, dtype=torch.complex64)),  # empty
    lambda: kernels.cmul_max(torch.zeros(4, dtype=torch.complex64),
                             torch.zeros(4, dtype=torch.complex64,
                                         device="meta")),          # devices
    lambda: kernels.cmul_max(torch.zeros(4, dtype=torch.complex64),
                             torch.zeros(4, dtype=torch.complex64),
                             m=torch.zeros(1)),                    # m 0-d
    lambda: kernels.power_max(torch.zeros(4)),                     # dtype
    lambda: kernels.power_max(torch.zeros((2, 8), dtype=torch.complex64)
                              [:, ::2]),                           # layout
    lambda: kernels.power_max(torch.zeros(0, dtype=torch.complex64)),  # empty
    lambda: kernels.pencil_dft(torch.zeros((2, 3), dtype=torch.complex128),
                               _EYE2),                             # dtype
    lambda: kernels.pencil_dft(torch.zeros((2, 3), dtype=torch.complex64),
                               _EYE2.to(torch.complex128)),        # dtype
    lambda: kernels.pencil_dft(torch.zeros((2, 6), dtype=torch.complex64)
                               [:, ::2], _EYE2),                   # layout
    lambda: kernels.pencil_dft(torch.zeros((3, 3), dtype=torch.complex64),
                               _EYE2),                             # P
    lambda: kernels.pencil_dft(torch.zeros((2, 3), dtype=torch.complex64),
                               _EYE2[:, :1].contiguous()),         # W
    lambda: kernels.pencil_dft(torch.zeros(2, dtype=torch.complex64),
                               _EYE2),                             # 1-D
    lambda: kernels.pencil_dft(torch.zeros((2, 3), dtype=torch.complex64),
                               _EYE2, torch.ones(
                                   5, dtype=torch.complex64)),     # twiddle
    lambda: kernels.pencil_dft(torch.zeros((2, 3), dtype=torch.complex64),
                               _EYE2, torch.ones(
                                   6, dtype=torch.complex64,
                                   device="meta")),                # devices
    lambda: kernels.pencil_twiddle_pack(
        torch.zeros(6, dtype=torch.complex128),
        torch.ones(6, dtype=torch.complex64), 2),                  # dtype
    lambda: kernels.pencil_twiddle_pack(
        torch.zeros((2, 12), dtype=torch.complex64)[:, ::2],
        torch.ones(6, dtype=torch.complex64), 2),                  # layout
    lambda: kernels.pencil_twiddle_pack(
        torch.zeros(6, dtype=torch.complex64),
        torch.ones(6, dtype=torch.complex64), 4),                  # B % P
    lambda: kernels.pencil_twiddle_pack(
        torch.zeros(6, dtype=torch.complex64),
        torch.ones(3, dtype=torch.complex64), 2),                  # twiddle
    lambda: kernels.pencil_twiddle_pack(
        torch.zeros(6, dtype=torch.complex64),
        torch.ones(6, dtype=torch.complex64, device="meta"), 2),   # devices
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
