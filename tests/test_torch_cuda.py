"""The port on an NVIDIA card: each hand-written kernel against its plain
PyTorch version, and the link and the staged README chain on the card
against the same on the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu_torch import devices, gv, link, ook
from opticomlib_tpu_torch.ops import kernels
from opticomlib_tpu_torch.ops.prbs import prbs
from opticomlib_tpu_torch.params import SimParams

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.reset_launches()
    return torch.device("cuda")


def _field(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.3 * torch.randn(shape, generator=g, device=device,
                             dtype=torch.complex64)


@pytest.mark.parametrize("shape", [(2**20,), (2**20 + 5,), (2, 4099)])
def test_kick_and_cmul_match_plain(cuda_device, shape):
    A = _field(shape, 1, cuda_device)
    E = _field(shape[-1:], 2, cuda_device)
    B, H = kernels.nl_halfstep(A, 0.05)
    Br, Hr = kernels.nl_halfstep_ref(A, 0.05)
    torch.testing.assert_close(B, Br, **TOL)
    torch.testing.assert_close(H, Hr, **TOL)
    torch.testing.assert_close(kernels.cmul(A, E), kernels.cmul_ref(A, E),
                               **TOL)
    torch.testing.assert_close(kernels.cmul(A, B), kernels.cmul_ref(A, B),
                               **TOL)
    assert kernels.LAUNCHES["nl_halfstep"] == 1
    assert kernels.LAUNCHES["cmul"] == 2


@pytest.mark.parametrize("shape,broadcast", [
    ((2**20,), False), ((2**20 + 1,), False), ((1,), False), ((3,), False),
    ((2, 2**20), True), ((2, 2**20), False), ((2, 4099), True),
    ((2, 4100), True), ((5, 3, 1026), True), ((1024 * 4 * 2 + 2,), False)])
@pytest.mark.parametrize("misalign", ["none", "A", "B", "all"])
def test_cmul_kernel_bit_equal_to_plain(cuda_device, shape, broadcast,
                                        misalign):
    """Every path of the launcher (16-byte vectors, the odd last sample,
    the scalar kernel for an odd row length under a broadcast and for views
    8 bytes off a 16-byte boundary) gives the bits of ``A * B``: the kernel
    rounds as torch's complex product does on the card."""
    def make(sh, seed, off):
        n = int(np.prod(sh))
        buf = _field((n + 1,), seed, cuda_device)
        return buf[off:off + n].reshape(sh)

    A = make(shape, 3, misalign in ("A", "all"))
    B = make(shape[-1:] if broadcast else shape, 4, misalign in ("B", "all"))
    assert A.is_contiguous() and B.is_contiguous()
    C = kernels.cmul(A, B)
    torch.cuda.synchronize()
    assert torch.equal(C, kernels.cmul_ref(A, B))
    assert kernels.LAUNCHES["cmul"] == 1


def _bits_view(shape, seed, off, device):
    """A contiguous complex64 field of ``shape`` whose storage starts
    ``off`` samples (8 bytes each) past an allocation."""
    n = int(np.prod(shape))
    return _field((n + 1,), seed, device)[off:off + n].reshape(shape)


@pytest.mark.parametrize("shape", [
    (2**24,), (2**20 + 3,), (2, 2**20), (2, 4099), (2, 4100), (5, 3, 1026),
    (1,), (3,), (2**20 - 1,)])
@pytest.mark.parametrize("misalign", ["none", "X", "phi"])
def test_spectral_phase_kernel_bit_equal_to_plain(cuda_device, shape,
                                                  misalign):
    """The factor built in registers gives the bits of the plain
    ``X * polar(loss*s, phi*h)`` on every path of the launcher: 16-byte
    vectors with one row or two, the odd last sample of one row, the scalar
    kernel (an odd row length under two rows, views off their boundary);
    the 1/n folded at the power-of-two lengths only."""
    X = _bits_view(shape, 21, int(misalign == "X"), cuda_device)
    n = shape[-1]
    buf = torch.randn(n + 1, generator=torch.Generator(
        device=cuda_device).manual_seed(22), device=cuda_device) * 40
    phi = buf[int(misalign == "phi"):][:n]
    loss, h = np.float32(0.99540436), np.float32(0.7310085)
    want = kernels.spectral_phase_ref(X, phi, loss, h)
    assert kernels.spectral_phase(X, phi, loss, h) is X
    torch.cuda.synchronize()
    assert torch.equal(X, want)
    assert kernels.LAUNCHES["spectral_phase"] == 1


@pytest.mark.parametrize("shape", [
    (2**24,), (2**20 + 1,), (2, 2**20), (2, 4099), (1,), (3,),
    (1024 * 4 * 2 + 2,), (1024 * 4 * 2 + 3,)])
@pytest.mark.parametrize("misalign", ["none", "A", "all"])
def test_cmul_max_kernel_bit_equal_to_plain(cuda_device, shape, misalign):
    """The product and its ``max(re^2 + im^2)`` in one pass give the bits of
    ``A * H`` and of ``view_as_real(A * H).square().sum(-1).max()``, in
    place too, and twice in a row (the scratch is zero again after a
    launch); ``power_max`` gives the maximum of ``A`` alone."""
    A = _bits_view(shape, 23, int(misalign in ("A", "all")), cuda_device)
    H = _bits_view(shape, 24, int(misalign == "all"), cuda_device)
    Cr, mr = kernels.cmul_max_ref(A, H)
    for _ in range(2):
        C, m = kernels.cmul_max(A, H)
        assert torch.equal(C, Cr) and torch.equal(m, mr)
        assert m.ndim == 0 and m.dtype == torch.float32
        assert torch.equal(kernels.power_max(A), kernels.power_max_ref(A))
    m0 = torch.empty((), device=cuda_device)
    Cin, m1 = kernels.cmul_max(A, H, out=A, m=m0)
    torch.cuda.synchronize()
    assert Cin is A and m1 is m0
    assert torch.equal(A, Cr) and torch.equal(m0, mr)
    assert kernels.LAUNCHES["cmul_max"] == 5


@pytest.mark.parametrize("where", [0, 2**20 - 1, 777_777])
def test_cmul_max_propagates_nan_and_inf(cuda_device, where):
    """An infinite sample makes the maximum infinite; a NaN anywhere makes
    it NaN, as ``torch.max`` does."""
    A = _field((2**20,), 25, cuda_device)
    H = _field((2**20,), 26, cuda_device)
    A[where] = complex(float("inf"), 1.0)
    assert kernels.power_max(A).item() == float("inf")
    assert kernels.cmul_max_ref(A, H)[1].item() == float("inf")
    assert kernels.cmul_max(A, H)[1].item() == float("inf")
    A[where] = 1.0
    A[(where + 12345) % A.numel()] = complex("nan")
    assert np.isnan(kernels.power_max_ref(A).item())
    assert np.isnan(kernels.power_max(A).item())
    assert np.isnan(kernels.cmul_max(A, H)[1].item())


#: (P, lead, C, offset in samples): the four-card cell's rank field (8
#: channels of B = 2^23 at P = 2) and the same 2^26 samples at P = 1 and 4,
#: then small fields on every path of the launchers: C odd (one sample a
#: thread) and even (16-byte vectors), views 8 bytes off a 16-byte boundary,
#: the any-P kernel (P = 3 and 8)
_PENCIL_CASES = [(2, (8,), 2**22, 0), (1, (8,), 2**23, 0),
                 (4, (8,), 2**21, 0)] + [
    (P, (3, 2), C, off) for P in (1, 2, 3, 4, 8) for C in (1003, 1004)
    for off in (0, 1)]


def _pencil_inputs(P, lead, C, off, seed, device):
    """A contiguous complex64 ``(P, *lead, C)`` field starting ``off``
    samples into its allocation, and the transform constants of the last
    rank of a P-rank axis (both twiddles non-trivial for P > 1)."""
    from opticomlib_tpu_torch.parallel.dfft import _transform_consts
    shape = (P,) + lead + (C,)
    n = int(np.prod(shape))
    z = _field((n + off,), seed, device)[off:].reshape(shape)
    assert z.is_contiguous()
    return z, _transform_consts(P, P * C, P - 1, device)


@pytest.mark.parametrize("P,lead,C,off", _PENCIL_CASES)
def test_pencil_dft_kernel_matches_einsum(cuda_device, P, lead, C, off):
    """The DFT pass, with the forward twiddle and without (the inverse),
    against its plain version (the einsum, ``cmul`` and the pack): each
    component within ``3P + 2`` float32 ulps of ``P * max|z|`` (each side
    rounds 2P fused multiply-adds of at most that size, and the twiddle
    turns the difference through sqrt(2) and adds two roundings a side:
    ``2*sqrt(2)*P + 2``); and against a float64 DFT of the same complex64
    constants, no farther than the einsum, max and relative L2."""
    z, (W_f, W_i, tw_f, _) = _pencil_inputs(P, lead, C, off, 27, cuda_device)
    ulp = 2.0**-23 * P * float(z.abs().max())
    c128 = torch.complex128
    for W, tw in ((W_f, tw_f), (W_i, None)):
        got = kernels.pencil_dft(z, W, tw)
        want = kernels.pencil_dft_ref(z, W, tw)
        torch.cuda.synchronize()
        assert got.shape == z.shape and got.is_contiguous()
        err = float((torch.view_as_real(got)
                     - torch.view_as_real(want)).abs().max())
        assert err <= (3 * P + 2) * ulp, (err / ulp, tw is None)
        ref = torch.einsum("kn,n...c->k...c", W.to(c128), z.to(c128))
        if tw is not None:
            ref = ref * tw.to(c128).reshape((P,) + (1,) * len(lead) + (C,))
        d_got, d_want = got.to(c128) - ref, want.to(c128) - ref
        assert d_got.abs().max() <= d_want.abs().max()
        assert d_got.norm() <= d_want.norm()
    assert kernels.LAUNCHES["pencil"] == 2


@pytest.mark.parametrize("P,lead,C,off", _PENCIL_CASES)
def test_pencil_twiddle_pack_kernel_bit_equal_to_plain(cuda_device, P, lead,
                                                       C, off):
    """The inverse's twiddle-and-pack gives the bits of ``cmul`` by the
    twiddle and the pack: the kernel rounds its product as ``A * B`` does
    on the card."""
    z, consts = _pencil_inputs(P, lead, C, off, 28, cuda_device)
    u = z.reshape(lead + (P * C,))
    got = kernels.pencil_twiddle_pack(u, consts[3], P)
    torch.cuda.synchronize()
    assert got.shape == z.shape and got.is_contiguous()
    assert torch.equal(got, kernels.pencil_twiddle_pack_ref(u, consts[3], P))
    assert kernels.LAUNCHES["pencil"] == 1


def _fiber_inputs(monkeypatch, call):
    """The arguments the link hands its adaptive fiber loop during
    ``call()``, the field cloned."""
    from opticomlib_tpu_torch.ops import ssfm
    seen, orig = [], ssfm.ssfm_while_inside

    def spy(A, *args, **kw):
        seen.append((A.clone(), args, kw))
        return orig(A, *args, **kw)

    monkeypatch.setattr(ssfm, "ssfm_while_inside", spy)
    call()
    monkeypatch.setattr(ssfm, "ssfm_while_inside", orig)
    return seen


def _cell_link(cell, device):
    """The link and one call of the benchmark's adaptive cells at 2^24
    samples: BASELINE config 2 (``ook_50km``) and config 3 with the hard
    PPM receiver (``ppm8_20km``)."""
    fiber = dict(length=50.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                 phi_max=0.01)
    tx = dict(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
              pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9)
    if cell == "ook_50km":
        spec = link.LinkSpec(**tx, stages=(link.FiberSpec(**fiber),
                                           link.EDFASpec(G=10, NF=5)))
        prog = link.build_link(spec, 2**18, SimParams.create(
            sps=64, R=10e9, _warn=False), device=device)
        bits = prbs(15, length=2**18)[0]
        return lambda: prog.dsp(bits=bits, seed=3)
    spec = link.LinkSpec(**tx, stages=(
        link.FiberSpec(**dict(fiber, length=20.0)),
        link.BPFSpec(BW=15e9, n=4)))
    prog = link.build_link(spec, 2**16 * 8, SimParams.create(
        sps=32, R=10e9, _warn=False), device=device)
    bits = prbs(15, length=2**16 * 3)[0]
    return lambda: prog.dsp_ppm(8, decision="hard", bits=bits, seed=3)


@pytest.mark.parametrize("cell,steps", [("ook_50km", 58), ("ppm8_20km", 36)])
def test_fused_adaptive_loop_bit_equal_to_composed(cuda_device, monkeypatch,
                                                   cell, steps):
    """On the benchmark cells' launch fields at 2^24 samples the fused loop
    (five launches a step) takes the composed loop's steps and ends on its
    bits: the folded 1/n commutes with cuFFT's roundings, the factor and
    the product round as before and the maximum is order-free."""
    from opticomlib_tpu_torch.ops import ssfm
    ((A, args, kw),) = _fiber_inputs(monkeypatch,
                                     _cell_link(cell, cuda_device))
    assert A.numel() == 2**24 and A.dtype == torch.complex64
    monkeypatch.setattr(ssfm, "STEP_COUNTS", dict(fused=0, composed=0))
    kernels.reset_launches()
    fused, n_f = ssfm.ssfm_while_inside(A.clone(), *args, **kw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    monkeypatch.setattr(ssfm, "_fuses", lambda A: False)
    composed, n_c = ssfm.ssfm_while_inside(A.clone(), *args, **kw)
    assert n_f == n_c == steps
    assert ssfm.STEP_COUNTS == dict(fused=steps, composed=steps)
    assert launches["nl_halfstep"] == launches["spectral_phase"] == steps
    assert launches["cmul_max"] == steps and launches["cmul"] == 0
    assert torch.equal(fused, composed), float(
        (fused - composed).abs().max())


def test_fused_loop_hands_its_scalar_to_reduce_max(cuda_device):
    """The ``reduce_max`` hook gets the fused step's 0-d device maximum
    (the loop's one buffer) before each read-back; hooked or not, the loop
    takes the same steps to the same bits."""
    from opticomlib_tpu_torch.ops import ssfm
    n = 2**20
    A = _launch_field(n, 2, cuda_device)
    phi = torch.as_tensor(ssfm.dispersion_phase(
        2 * np.pi * np.fft.fftfreq(n) * 160e9, -20.0, 0.0),
        device=cuda_device)
    seen = []

    def hook(m):
        seen.append(m)
        return m

    args = (phi, 8.0, 1.3, 0.02, 0.3, ssfm.alpha_per_km(0.2))
    out, steps = ssfm.ssfm_while_inside(A, *args, adaptive=True,
                                        reduce_max=hook)
    ref, steps_r = ssfm.ssfm_while_inside(A, *args, adaptive=True)
    assert steps == steps_r == len(seen) > 5 and torch.equal(out, ref)
    assert all(m is seen[0] for m in seen)
    assert seen[0].ndim == 0 and seen[0].dtype == torch.float32
    assert seen[0].device == A.device
    assert torch.equal(seen[-1], kernels.power_max_ref(out))


def test_nan_field_takes_the_composed_steps(cuda_device, monkeypatch):
    """A field with a NaN sample ends the fused loop where it ends the
    composed one: the NaN maximum makes ``h`` NaN on both."""
    from opticomlib_tpu_torch.ops import ssfm
    n = 2**20
    A = _launch_field(n, 4, cuda_device)
    A[n // 3] = complex("nan")
    phi = torch.as_tensor(ssfm.dispersion_phase(
        2 * np.pi * np.fft.fftfreq(n) * 160e9, -20.0, 0.0),
        device=cuda_device)
    args = (phi, 8.0, 1.3, 0.02, 0.3, ssfm.alpha_per_km(0.2))
    fused, n_f = ssfm.ssfm_while_inside(A, *args, adaptive=True)
    monkeypatch.setattr(ssfm, "_fuses", lambda A: False)
    composed, n_c = ssfm.ssfm_while_inside(A, *args, adaptive=True)
    assert n_f == n_c
    assert torch.isnan(fused).all() and torch.isnan(composed).all()
    assert np.isnan(ssfm.max_power(fused)) and np.isnan(
        ssfm.max_power(composed))


def _composed_kicks(A, scale, c1, c2):
    """What the composed o4 scan launches at a substep boundary: the
    inverse FFT's exact scaling, then one ``nl_halfstep`` a kick."""
    x = kernels.nl_halfstep(torch.view_as_complex(
        torch.view_as_real(A) * scale), c1)[0]
    return x if c2 is None else kernels.nl_halfstep(x, c2)[0]


@pytest.mark.parametrize("shape", [
    (2**24,), (2**20 + 3,), (2, 2**20), (2, 4099), (5, 3, 1026), (1,),
    (3,)])
@pytest.mark.parametrize("misalign", [0, 1])
@pytest.mark.parametrize("two", [False, True])
def test_strang_kicks_kernel_bit_equal_to_composed_kicks(
        cuda_device, shape, misalign, two):
    """The boundary pass gives the bits of the launches it replaces (the
    scale, then one ``nl_halfstep`` kernel a kick, both coefficient signs),
    at odd lengths, two rows and a view 8 bytes off a 16-byte boundary, in
    place and into ``out``; its plain version rounds ``|x|^2`` without the
    kernels' fused multiply-add, as ``nl_halfstep_ref`` does, and is held
    to ``nl_halfstep``'s tolerance."""
    A = _bits_view(shape, 27, misalign, cuda_device).mul_(2**10)
    s = 2.0**-10
    c1, c2 = np.float32(3.71), (np.float32(-5.82) if two else None)
    want = _composed_kicks(A, s, c1, c2)
    got = kernels.strang_kicks(A, s, c1, c2, out=torch.empty_like(A))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    torch.testing.assert_close(got, kernels.strang_kicks_ref(A, s, c1, c2),
                               **TOL)
    assert kernels.strang_kicks(A, s, c1, c2) is A
    torch.cuda.synchronize()
    assert torch.equal(A, want)
    assert kernels.LAUNCHES["strang_kicks"] == 2


@pytest.mark.parametrize("n,two_pol,sgn", [
    (2**20, False, 1.0), (2**20, True, -1.0), (10**6, False, -1.0),
    (10**6, True, 1.0), (2**24, True, -1.0)])
def test_o4_scan_chain_bit_equal_to_composed(cuda_device, monkeypatch, n,
                                              two_pol, sgn):
    """``ssfm_o4_scan_inside`` on the card runs its substeps as one chain
    (a leading kick, then a transform pair and one ``strang_kicks`` pass a
    substep: 13 passes and no ``nl_halfstep`` for 4 steps) and ends on the
    composed scan's bits: forward and with the DBP's sign flip, one and two
    polarisations, a power-of-two length (the 1/n folded into the pass)
    and another (the inverse keeps it), an off-schedule last step; the
    last case is the benchmark's DBP span at its size."""
    from opticomlib_tpu_torch.ops import ssfm
    A = _launch_field(n, 5, cuda_device)
    if two_pol:
        A = torch.stack([A, 0.5 * _launch_field(n, 6, cuda_device)])
    fs = 160e9
    phi = torch.as_tensor(ssfm.dispersion_phase(
        2 * np.pi * np.fft.fftfreq(n) * fs, sgn * -21.0, 0.0),
        device=cuda_device)
    hs = (np.full(4, 20.0, np.float32) if n == 2**24
          else np.asarray([20.0, 20.0, 20.0, 10.0], np.float32))
    args = (phi, hs, sgn * 1.3, sgn * ssfm.alpha_per_km(0.2))
    monkeypatch.setattr(ssfm, "O4_COUNTS", dict(fused=0, composed=0))
    A0 = A.clone()
    chain = ssfm.ssfm_o4_scan_inside(A, *args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert torch.equal(A, A0)
    monkeypatch.setattr(ssfm, "_fuses", lambda A: False)
    composed = ssfm.ssfm_o4_scan_inside(A, *args)
    assert ssfm.O4_COUNTS == dict(fused=4, composed=4)
    assert launches["strang_kicks"] == 13 and launches["nl_halfstep"] == 0
    assert launches["cmul"] == 12
    assert torch.equal(chain, composed), float(
        (chain - composed).abs().max())


@pytest.mark.parametrize("n,nt,ny", [(2**20, 1, 4096), (2**20, 64, 256),
                                     (10_001, 256, 1024), (0, 1, 16)])
def test_histogram2d_kernel_matches_plain(cuda_device, n, nt, ny):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    t = torch.randint(-1, nt + 1, (n,), generator=g, device=cuda_device,
                      dtype=torch.int32)
    y = torch.randint(-1, ny + 1, (n,), generator=g, device=cuda_device,
                      dtype=torch.int32)
    got = kernels.histogram2d(t, y, nt, ny)
    assert torch.equal(got, kernels.histogram2d_ref(t, y, nt, ny))
    assert kernels.LAUNCHES["histogram2d"] == 1


def _eye_bins(n, ny, device, seed=0):
    """Bin indices as the receiver's KDE sees them: most samples masked
    (-1), the rest crowded around two levels."""
    g = torch.Generator(device=device).manual_seed(seed)
    level = torch.where(torch.rand(n, generator=g, device=device) > 0.5,
                        0.75, 0.25)
    v = level + 0.02 * torch.randn(n, generator=g, device=device)
    bins = torch.clamp((v * ny).to(torch.int32), 0, ny - 1)
    window = torch.rand(n, generator=g, device=device) < 0.1
    return torch.where(window, bins, -1)


def _view(flat, off, shape):
    """``flat`` values as a contiguous tensor of ``shape`` whose storage
    starts ``off`` int32 elements (4 bytes each) past an allocation."""
    buf = torch.empty(flat.numel() + off, dtype=flat.dtype,
                      device=flat.device)
    buf[off:] = flat.reshape(-1)
    return buf[off:].reshape(shape)


@pytest.mark.parametrize("nrow,n,ny", [
    (1, 2**20, 4096), (16, 2**20, 4096), (16, 2**18, 8192), (1, 2**20 + 3, 4096),
    (3, 4099, 4096), (5, 1, 16), (2, 0, 16), (1, 2**18, 40_000),
    (1, 2**16, 300_000), (300, 1000, 64)])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("data", ["eye", "uniform"])
def test_histogram_rows_kernel_exact(cuda_device, nrow, n, ny, off, data):
    """The row-batched entry against its plain version, exact counts: the
    receivers' shapes, odd lengths (rows then start 4, 8 or 12 bytes off a
    16-byte boundary), views 4, 8 and 12 bytes off, one block a row, more
    bins than a tile (40,000) and than the tiles cover (300,000: the global
    path), empty rows; eye-like and uniform bins with out-of-range samples
    on both sides."""
    if data == "eye":
        flat = _eye_bins(nrow * n, ny, cuda_device)
    else:
        g = torch.Generator(device=cuda_device).manual_seed(1)
        flat = torch.randint(-2, ny + 2, (nrow * n,), generator=g,
                             device=cuda_device, dtype=torch.int32)
    y = _view(flat, off, (nrow, n))
    assert y.is_contiguous() and (y.data_ptr() % 16 == 4 * off or n == 0)
    for _ in range(2):   # the second launch finds the scratch zero again
        got = kernels.histogram_rows(y, ny)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.histogram_rows_ref(y, ny))
    assert kernels.LAUNCHES["histogram2d"] == 2


@pytest.mark.parametrize("n,nt,ny", [
    (2**20, 1, 4096), (2**22, 256, 256), (2**20, 16, 8192), (2**20 + 1, 64, 256),
    (10_001, 256, 1024), (2**18, 1024, 1024), (0, 1, 16), (0, 512, 512),
    (5, 3, 3)])
@pytest.mark.parametrize("off_t,off_y", [(0, 0), (1, 1), (3, 3), (0, 1),
                                         (2, 0)])
def test_histogram2d_kernel_exact(cuda_device, n, nt, ny, off_t, off_y):
    """The 2-D entry against its plain version, exact counts: one tile,
    several tiles ((256, 256), (16, 8192), (256, 1024)), a table on the
    global path ((1024, 1024)), empty input; both arrays the same distance
    off a 16-byte boundary (vector loads) or not (element loads); indices
    out of range on both sides; all-masked input."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    t = _view(torch.randint(-1, nt + 1, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32), off_t, (n,))
    y = _view(torch.randint(-1, ny + 1, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32), off_y, (n,))
    for yy in (y, torch.full_like(y, -1)):
        got = kernels.histogram2d(t, yy, nt, ny)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.histogram2d_ref(t, yy, nt, ny))
    assert kernels.LAUNCHES["histogram2d"] == 2


def test_histogram_hot_bin_and_streams(cuda_device):
    """Every sample in one bin (the worst contention) counts exactly, and
    launches on two streams keep their scratch apart."""
    y = torch.full((4, 2**20), 7, dtype=torch.int32, device=cuda_device)
    want = kernels.histogram_rows_ref(y, 4096)
    assert torch.equal(kernels.histogram_rows(y, 4096), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = kernels.histogram_rows(y, 4096)
    b = kernels.histogram_rows(y, 4096)
    torch.cuda.synchronize()
    assert torch.equal(a, want) and torch.equal(b, want)


def test_sweep_is_one_histogram_launch(cuda_device):
    """A 3-channel ``dsp_wdm`` on the card equals the per-channel ``dsp``
    calls (error and step counts equal, thresholds rel 1e-6) with one
    histogram launch for the sweep."""
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=-18.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        include_shot=False)
    prog = link.build_link(spec, 2**12, SimParams.create(
        sps=16, R=10e9, _warn=False), device=cuda_device)
    bits = prbs(15, length=3 * 2**12)[0].reshape(3, -1)
    kernels.reset_launches()
    sw = prog.dsp_wdm(3, bits=bits, seed=5)
    assert kernels.LAUNCHES["histogram2d"] == 1
    for c in range(3):
        d = prog.dsp(bits=bits[c], seed=5 + c, sps_resamp=None)
        assert sw.n_errors[c] == d.n_errors and sw.n_steps[c] == d.n_steps
        assert abs(sw.threshold[c] - d.threshold) <= 1e-6 * abs(d.threshold)


def test_wrappers_reject_mixed_devices(cuda_device):
    A = _field(16, 3, cuda_device)
    with pytest.raises(ValueError):
        kernels.cmul(A, A.cpu())


def test_link_on_card_matches_cpu(cuda_device):
    """BASELINE config 2 at 2^12 bits x sps 64 on the same numpy noise: the
    same step count, v within rel L2 1e-4, the same error count."""
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=16.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=(link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                               gamma=1.3),
                link.EDFASpec(G=10, NF=5)))
    params = SimParams.create(sps=64, R=10e9, _warn=False)
    n_bits = 2**12
    n = n_bits * 64
    rng = np.random.default_rng(1)
    noise = {"ase": [rng.standard_normal((4, n), dtype=np.float32)],
             "thermal": rng.standard_normal(n, dtype=np.float32),
             "shot": rng.standard_normal(n, dtype=np.float32)}
    bits = prbs(15, length=n_bits)[0]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        prog = link.build_link(spec, n_bits, params, device=dev)
        out[dev.type] = (prog.run(bits=bits, noise=noise),
                         prog.dsp(bits=bits, noise=noise))
    (rg, dg), (rc, dc) = out["cuda"], out["cpu"]
    assert rg.n_steps == rc.n_steps
    v_g, v_c = rg.v.to_numpy(), rc.v.to_numpy()
    assert np.linalg.norm(v_g - v_c) / np.linalg.norm(v_c) <= 1e-4
    assert dg.n_errors == dc.n_errors
    assert abs(dg.threshold - dc.threshold) <= abs(
        dc.eye.mu1 - dc.eye.mu0) / 999 * (1 + 1e-3)
    assert kernels.LAUNCHES["histogram2d"] >= 1
    assert kernels.LAUNCHES["nl_halfstep"] >= rg.n_steps[0]


@pytest.mark.parametrize("n", [2**20, 2**20 + 3, 5])
def test_adc_link_mode_bit_equal_to_plain(cuda_device, n):
    """Link mode with lo/hi as device scalars: the same output bits as the
    plain version (no FMA contraction in the kernel), outliers included."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    v = 0.1 * torch.randn(n, generator=g, device=cuda_device) + 0.12
    lo, hi = v.quantile(0.001) if n > 16 else v.min(), v.max() * 0.9
    for bits in (1, 6, 8, 16):
        got = kernels.adc_quantize_link(v, lo.contiguous(), hi.contiguous(),
                                        bits)
        assert torch.equal(got, kernels.adc_quantize_link_ref(v, lo, hi, bits))
    assert kernels.LAUNCHES["adc_quantize"] == 4


def test_adc_kernel_mode_matches_plain_and_rounds_half_up(cuda_device):
    x = torch.arange(15, dtype=torch.float32, device=cuda_device) + 0.5
    got = kernels.adc_quantize(x, 0.0, 15.0, 4)
    assert torch.equal(got, kernels.adc_quantize_ref(x, 0.0, 15.0, 4))
    assert torch.equal(got.cpu(), torch.arange(1, 16, dtype=torch.float32))
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2**20 + 1, generator=g, device=cuda_device)
    assert torch.equal(kernels.adc_quantize(x, -2.0, 2.0, 8),
                       kernels.adc_quantize_ref(x, -2.0, 2.0, 8))
    # a view that is not 16-byte aligned takes the scalar loop
    xs = x[1:]
    assert torch.equal(kernels.adc_quantize(xs, -2.0, 2.0, 8),
                       kernels.adc_quantize_ref(xs, -2.0, 2.0, 8))


def test_adc_stochastic_statistics(cuda_device):
    x = torch.full((2**20,), 0.30, device=cuda_device)
    y = kernels.adc_quantize(x, 0.0, 1.0, 2, stochastic=True, seed=3)
    step = 1.0 / 3.0
    q = (y / step).cpu().numpy()
    np.testing.assert_allclose(q, np.round(q), atol=1e-4)
    # 0.3 is 0.9 of a step: the level above w.p. 0.9, below w.p. 0.1
    assert abs(float(y.double().mean()) - 0.30) < 3 * step * np.sqrt(
        0.9 * 0.1 / x.numel())
    assert torch.equal(y, kernels.adc_quantize(x, 0.0, 1.0, 2,
                                               stochastic=True, seed=3))
    assert not torch.equal(y[:65536], y[65536:131072])


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 2048 + 4,
                               2**20 + 3])
@pytest.mark.parametrize("taps", [1, 7, 8, 9, 64, 783, kernels.FIR_MAX_TAPS])
def test_fir_filter_matches_plain(cuda_device, n, taps):
    """Within 1e-5 of max|y| (float32 sums in another order than cuDNN's
    full-float32 convolution); lengths around the 1024-output block, tap
    counts around the 8-tap chunk, taps longer than the input."""
    g = torch.Generator(device=cuda_device).manual_seed(n + taps)
    x = torch.randn(n, generator=g, device=cuda_device)
    h = torch.randn(taps, generator=g, device=cuda_device)
    y, yr = kernels.fir_filter(x, h), kernels.fir_filter_ref(x, h)
    torch.cuda.synchronize()
    assert float((y - yr).abs().max()) <= 1e-5 * float(yr.abs().max())
    assert kernels.LAUNCHES["fir_filter"] == 1


def test_fir_filter_misaligned_views(cuda_device):
    """Input and output views 4 bytes off a 16-byte boundary take the
    element-wise staging and stores: the same bits as the aligned call."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(300 * 1024 + 8, generator=g, device=cuda_device)
    h = torch.randn(100, generator=g, device=cuda_device)
    want = kernels.fir_filter(x[1:].clone(), h)
    assert torch.equal(kernels.fir_filter(x[1:], h), want)


def test_fir_filter_delta_and_limits(cuda_device):
    x = torch.randn(10_001, device=cuda_device)
    h = torch.zeros(11, device=cuda_device)
    h[0] = 1.0
    assert torch.equal(kernels.fir_filter(x, h), x)
    with pytest.raises(ValueError, match="taps"):
        kernels.fir_filter(x, torch.ones(kernels.FIR_MAX_TAPS + 1,
                                         device=cuda_device))
    with pytest.raises(ValueError):
        kernels.fir_filter(x, h.cpu())
    assert kernels.fir_filter(x[:0], h).numel() == 0
    assert kernels.LAUNCHES["fir_filter"] == 1


def test_staged_chain_on_card_matches_cpu(cuda_device):
    """The README chain at 2^10 bits x sps 64 on the same numpy draws: the
    same steps and decisions, the PD voltage within relative L2 1e-4."""
    out = {}
    for dev in ("cuda", "cpu"):
        gv.default()
        gv(sps=64, R=10e9, Vpi=5, N=2**10, device=dev)
        np.random.seed(0)
        tx = devices.PRBS(order=15, len=gv.N)
        v = devices.DAC(tx, Vpp=5, offset=-2.5, pulse_shape="gaussian")
        mod = devices.MZM(devices.LASER(P0=5), v, bias=-2.5, Vpi=5,
                          loss_dB=3, ER_dB=26)
        fib = devices.FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2)
        pdo = devices.PD(fib, BW=7.5e9, include_noise="all")
        rx, _, rth = ook.DSP(pdo)
        assert pdo.device.type == dev
        out[dev] = (fib.n_steps, pdo.to_numpy(), rx.data, rth)
    gv.default()
    (sg, vg, rg, tg), (sc, vc, rc, tc) = out["cuda"], out["cpu"]
    assert sg == sc
    assert np.linalg.norm(vg - vc) / np.linalg.norm(vc) <= 1e-4
    assert np.array_equal(rg, rc)
    assert kernels.LAUNCHES["fir_filter"] >= 1
    assert kernels.LAUNCHES["nl_halfstep"] >= sg


def test_staged_injected_draws_and_fiber_span_on_card(cuda_device):
    """On the card: ``PD``, ``LASER`` and ``EDFA`` on injected draws equal
    their keyed draws (the same CUDA generator's), and the staged
    ``FIBER``'s span says that its steps took the fused kernels."""
    from opticomlib_tpu_torch.utils import profiling
    gv.default()
    gv(sps=64, R=10e9, Vpi=5, N=2**12, device="cuda")
    n = 2**12 * 64

    def randn(*shapes):
        g = torch.Generator(device=cuda_device).manual_seed(11)
        return [torch.randn(s, generator=g, device=cuda_device)
                for s in shapes]
    v = devices.DAC(prbs(15, length=2**12)[0], Vpp=5, offset=-2.5,
                    pulse_shape="gaussian")
    E = devices.MZM(devices.LASER(P0=5), v, bias=-2.5, Vpi=5, loss_dB=3,
                    ER_dB=26)
    th, sh = randn((n,), (n,))
    assert torch.equal(
        devices.PD(E, BW=7.5e9, key=11)._total(),
        devices.PD(E, BW=7.5e9, noise={"thermal": th, "shot": sh})._total())
    ph, ri = randn((n,), (n,))
    assert torch.equal(
        devices.LASER(P0=3, lw=1e6, rin=-150, key=11).signal,
        devices.LASER(P0=3, lw=1e6, rin=-150,
                      noise={"phase": ph, "rin": ri}).signal)
    (ase,) = randn((4, n))
    assert torch.equal(devices.EDFA(E, G=20, NF=5, key=11).noise,
                       devices.EDFA(E, G=20, NF=5, noise={"ase": ase}).noise)
    profiling.record(True)
    try:
        fib = devices.FIBER(E, length=50, alpha=0.2, beta_2=-20, gamma=2)
        recs = profiling.drain()
    finally:
        profiling.record(False)
        gv.default()
    (sp,) = [r for r in recs if r["name"] == "fiber"]
    assert sp["attrs"] == {"kind": "staged", "method": "reference",
                           "steps": fib.n_steps, "fused": True}


def test_staged_fiber_constants_on_card_equal_the_hosts(cuda_device):
    """On the card at 2^24: ``FIBER``'s frequency axis and, for beta_3 = 0,
    its dispersion phase are the host's bits (beta_3 != 0: within a
    float32 ulp); the low-pass's cached response gives the host copy's
    output; a staged ``FIBER`` equals ``ssfm_propagate`` on the host's
    axis."""
    from opticomlib_tpu_torch.ops import filters, ssfm
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv.default()
    gv(sps=64, R=10e9, Vpi=5, N=2**18, device="cuda")
    try:
        A = torch.zeros(2**24, dtype=torch.complex64, device=cuda_device)
        w_host, w = OpticalSignal(A).w(), devices._w_on(A)
        assert np.array_equal(w.cpu().numpy().view(np.uint64),
                              w_host.view(np.uint64))
        got = ssfm.dispersion_phase(w, -20.0, 0.0).cpu().numpy()
        want = ssfm.dispersion_phase(w_host, -20.0, 0.0)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        got = ssfm.dispersion_phase(w, -21.0, 0.1).cpu().numpy()
        want = ssfm.dispersion_phase(w_host, -21.0, 0.1)
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
        del A, w
        x = torch.randn(2**24, dtype=torch.float64, device=cuda_device)
        H2 = filters.bessel_filtfilt_response(4, 7.5e9, gv.fs, 2**24)
        ref = filters.apply_freq_response(x, torch.as_tensor(
            H2.astype(np.float64), device=cuda_device))
        assert torch.equal(filters.bessel_lpf(x, 7.5e9, gv.fs), ref)
        del x, ref
        gv(sps=64, R=10e9, Vpi=5, N=2**12, device="cuda")
        v = devices.DAC(prbs(15, length=2**12)[0], Vpp=5, offset=-2.5)
        E = devices.MZM(devices.LASER(P0=5), v, bias=-2.5, Vpi=5,
                        loss_dB=3, ER_dB=26)
        fib = devices.FIBER(E, length=50, alpha=0.2, beta_2=-20, gamma=2)
        B, steps = ssfm.ssfm_propagate(E._total(), E.w(), 50.0, alpha=0.2,
                                       beta_2=-20.0, gamma=2.0)
        assert fib.n_steps == steps and torch.equal(fib.signal, B)
    finally:
        gv.default()


# ---------------------------------------------------------------------------
# the resumable and the sharded fiber, and the profiling hooks, on the card
# ---------------------------------------------------------------------------
def _launch_field(n, seed, device):
    """An NRZ-like band-limited field of peak power ~0.04 W."""
    from scipy.ndimage import gaussian_filter1d
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n // 16).astype(float)
    x = gaussian_filter1d(np.repeat(bits, 16), 4).astype(np.complex64) * 0.2
    return torch.as_tensor(x, device=device)


def test_resumable_on_card_kill_and_resume(cuda_device, tmp_path):
    """2^20 samples: the field stays on the card between segments, a run
    killed after its 2nd save resumes to the bits of the whole run, and the
    kicks and products go through the kernels."""
    from opticomlib_tpu_torch import runtime
    from opticomlib_tpu_torch.ops import ssfm
    from opticomlib_tpu_torch.runtime.checkpoint import \
        PropagationCheckpointer
    n = 2**20
    A = _launch_field(n, 0, cuda_device)
    w = 2 * np.pi * np.fft.fftfreq(n) * 160e9
    kw = dict(alpha=0.2, beta_2=-20, gamma=1.3, phi_max=0.02)
    whole = runtime.ssfm_propagate_resumable(
        A, w, 8.0, str(tmp_path / "whole"), 2.0, **kw)
    assert whole.device == A.device and whole.dtype == torch.complex64
    # adaptive: every step fused, the first step sizes from power_max
    n_steps = kernels.LAUNCHES["nl_halfstep"]
    assert n_steps > 0 and kernels.LAUNCHES["cmul"] == 0
    assert kernels.LAUNCHES["spectral_phase"] == n_steps
    assert kernels.LAUNCHES["cmul_max"] > n_steps
    orig, calls = PropagationCheckpointer.save, {"n": 0}

    def dying(self, *a, **k):
        out = orig(self, *a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return out

    PropagationCheckpointer.save = dying
    try:
        with pytest.raises(RuntimeError, match="boom"):
            runtime.ssfm_propagate_resumable(
                A, w, 8.0, str(tmp_path / "crash"), 2.0, **kw)
    finally:
        PropagationCheckpointer.save = orig
    resumed = runtime.ssfm_propagate_resumable(
        A, w, 8.0, str(tmp_path / "crash"), 2.0, **kw)
    assert torch.equal(resumed, whole)
    # fixed steps: the segments take the straight run's steps
    fixed = dict(alpha=0.2, beta_2=-20, gamma=1.3, h=0.5)
    straight, _ = ssfm.ssfm_propagate(A, w, 8.0, **fixed)
    seg = runtime.ssfm_propagate_resumable(
        A, w, 8.0, str(tmp_path / "fixed"), 2.0, **fixed)
    torch.testing.assert_close(seg, straight, atol=1e-5, rtol=0)
    # host data with no device named goes to the card
    gv.default()
    out = runtime.ssfm_propagate_resumable(
        A.cpu().numpy(), w, 8.0, str(tmp_path / "host"), 2.0, **fixed)
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, seg, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """World size 1 over NCCL: one rank, file rendezvous, a (1, 1) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_link_mesh)
    gv.default()  # no device named: the card, hence NCCL
    rendezvous = tmp_path_factory.mktemp("nccl") / "rendezvous"
    assert initialize_multihost(f"file://{rendezvous}", 1, 0,
                                timeout_s=120) == 1
    assert dist.get_backend() == "nccl"
    assert initialize_multihost() == 1          # idempotent
    yield make_link_mesh(1, 1)
    dist.destroy_process_group()


_FIBER20 = dict(length=20.0, alpha=0.2, beta_2=-20.0, gamma=1.3)


@pytest.mark.parametrize("name,kw,tol_peak", [
    ("pencil_adaptive", dict(h=None, phi_max=0.05), 5e-4),
    ("pencil_fixed", dict(h=0.5), 5e-4),
    ("overlap_fixed", dict(h=0.5, method="overlap"), 5e-3),
    ("overlap_adaptive", dict(h=None, phi_max=0.05, method="overlap"), 5e-3),
    ("auto", dict(h=0.5, method="auto"), 5e-4),
    ("o4_fixed", dict(h=2.0, scheme="o4"), 5e-4),
    ("o4_auto", dict(h=None, scheme="o4", tol=1e-5), 5e-4),
    ("local_error", dict(h=None, scheme="local_error", tol=1e-5), 5e-4),
])
def test_sharded_world_size_1_nccl(cuda_device, nccl_mesh, name, kw,
                                   tol_peak):
    """ssfm_sharded on one rank over NCCL at 2^20 samples against the
    unsharded call: the tolerances of tests/test_parallel.py, equal step
    counts on the pencil path, every kick and product through the
    kernels."""
    from opticomlib_tpu_torch.ops import ssfm
    from opticomlib_tpu_torch.parallel import ssfm_sharded
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    n, fs = 2**20, 160e9
    A = _launch_field(n, 3, cuda_device) * 1.5
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    out = ssfm_sharded(A, nccl_mesh, fs=fs, **_FIBER20, **kw)
    assert isinstance(out, ShardedField) and out.local.device == A.device
    assert kernels.LAUNCHES["nl_halfstep"] > 0
    assert kernels.LAUNCHES["cmul"] > 0
    plain = {k: v for k, v in kw.items() if k not in ("method", "scheme")}
    scheme = kw.get("scheme", "reference")
    if scheme == "reference":
        ref, steps = ssfm.ssfm_propagate(A, w, **_FIBER20, **plain)
    elif scheme == "o4" and kw["h"] is not None:
        ref, steps = ssfm.ssfm_scan_o4(A, w, **_FIBER20, **plain)
    else:
        plain.pop("h")
        fn = ssfm.ssfm_o4_auto if scheme == "o4" else ssfm.ssfm_local_error
        ref, steps = fn(A, w, **_FIBER20, **plain)
    err = float((out.local - ref).abs().max() / ref.abs().max())
    assert err <= tol_peak, err
    if kw.get("method") != "overlap":
        assert out.n_steps == steps
    host = np.asarray(out)                      # the gather
    assert np.array_equal(host, out.local.cpu().numpy())
    # the block is its own allocation (the overlap path cuts it out of a
    # padded buffer): 16-byte aligned for cmul's vector path
    assert out.local.data_ptr() % 16 == 0
    assert out.local.untyped_storage().nbytes() == 8 * n


@pytest.mark.parametrize("lead", [(), (2,), (3,), (3, 2)])
def test_pencil_transforms_launch_their_passes(cuda_device, nccl_mesh, lead):
    """``pencil_fft`` and ``pencil_ifft`` over NCCL at world size 1 run one
    pass forward and two inverse, nothing else in their place: the spectrum
    is ``torch.fft.fft``'s (P = 1: the strided layout is the natural one)
    and the round trip gives the field back."""
    from opticomlib_tpu_torch.parallel.dfft import pencil_fft, pencil_ifft
    axis = nccl_mesh.axis("time")
    x = _field(lead + (2**20,), 29, cuda_device)
    X = pencil_fft(x, axis)
    assert kernels.LAUNCHES["pencil"] == 1
    back = pencil_ifft(X, axis)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pencil"] == 3
    want = torch.fft.fft(x, dim=-1)
    assert float((X - want).abs().max() / want.abs().max()) <= 1e-6
    assert float((back - x).abs().max() / x.abs().max()) <= 1e-6


def test_mesh_of_cards_refuses_cpu_tensor(cuda_device, nccl_mesh):
    """A tensor is never moved between the host and the card behind the
    caller: a CPU tensor handed to a mesh of cards raises, host data is
    placed on the rank's card."""
    from opticomlib_tpu_torch.parallel import shard_waveform, ssfm_sharded
    A = _launch_field(2**12, 5, cuda_device)
    with pytest.raises(ValueError, match=r"initialize_multihost\(device="):
        shard_waveform(A.cpu(), nccl_mesh)
    with pytest.raises(ValueError, match=r"initialize_multihost\(device="):
        ssfm_sharded(A.cpu(), nccl_mesh, fs=160e9, length=1.0, beta_2=-20.0,
                     h=0.5)
    placed = shard_waveform(A.cpu().numpy(), nccl_mesh)
    assert placed.local.device == A.device
    assert torch.equal(placed.local, A)


def test_fiber_mesh_on_card(cuda_device, nccl_mesh):
    """FIBER(mesh=) with no device named: sharded payload on the card into
    the next stage; return_steps rejected."""
    from opticomlib_tpu_torch.parallel.fiber import ShardedField
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv.default()
    gv(sps=16, R=10e9, N=2**16)
    x = OpticalSignal(_launch_field(2**20, 7, cuda_device))
    kw = dict(length=10, alpha=0.2, beta_2=-20.0, gamma=1.3, phi_max=0.05)
    single = devices.FIBER(x, **kw)
    o1 = devices.FIBER(x, mesh=nccl_mesh, **kw)
    assert isinstance(o1.signal, ShardedField) and o1.device.type == "cuda"
    assert o1.n_steps == single.n_steps
    a, b = o1.to_numpy(), single.to_numpy()
    assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b))
    o2 = devices.FIBER(o1, mesh=nccl_mesh, **kw)
    assert isinstance(o2.signal, ShardedField)
    with pytest.raises(ValueError):
        devices.FIBER(x, mesh=nccl_mesh, return_steps=True, **kw)
    gv.default()


_SHARDED_STAGES = {
    "adaptive": (link.FiberSpec(length=50.0, alpha=0.2, beta_2=-21.0,
                                gamma=1.3),),
    "o4_dbp_adc": (link.FiberSpec(length=80.0, alpha=0.2, beta_2=-21.0,
                                  gamma=1.3, method="o4", h=20.0),
                   link.EDFASpec(G=16),
                   link.DBPSpec(length=80.0, alpha=0.2, beta_2=-21.0,
                                gamma=1.3, method="o4", h=20.0,
                                undo_gain_dB=16)),
}


@pytest.mark.parametrize("name", sorted(_SHARDED_STAGES))
def test_sharded_link_on_card(cuda_device, nccl_mesh, name):
    """build_link(mesh=) at world size 1 over NCCL, 2^16 bits x 16, against
    the unsharded link on the card: v within 2e-5 of the peak, equal steps;
    the kicks, products, histograms (and the ADC) through the kernels."""
    adc = name == "o4_dbp_adc"
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        include_thermal=False, include_shot=False,
        adc_bits=8 if adc else None, stages=_SHARDED_STAGES[name])
    params = SimParams.create(sps=16, R=10e9, _warn=False)
    n_bits = 2**16
    bits = prbs(15, length=n_bits)[0].astype(np.float32)
    prog = link.build_link(spec, n_bits, params, mesh=nccl_mesh)
    kernels.reset_launches()
    out = prog.jitted(bits, [0])
    d = prog.dsp(bits=bits, seed=0)
    ref = link.build_link(spec, n_bits, params, device=cuda_device)
    o0 = ref.jitted(torch.as_tensor(bits, device=cuda_device), 0)
    assert [int(s[0]) for s in out[2]] == list(o0[2])
    v1 = out[0].local[0]
    assert v1.device.type == "cuda"
    v0 = o0[0]
    if adc:  # the histogram range against the exact-sort range
        lsb = float(v0.max() - v0.min()) / 255
        assert float((v1 - v0).abs().max()) <= 1.5 * lsb
        assert kernels.LAUNCHES["adc_quantize"] >= 2
    else:
        assert float((v1 - v0).abs().max()) <= 2e-5 * float(v0.abs().max())
    assert d.n_errors == ref.dsp(bits=bits, seed=0).n_errors
    for k in ("nl_halfstep", "cmul", "histogram2d"):
        assert kernels.LAUNCHES[k] > 0, kernels.LAUNCHES


def test_sweep_over_card_mesh(cuda_device, nccl_mesh):
    """LinkProgram.dsp_wdm(mesh=) over a 1-D 'wdm' mesh of one card equals
    the plain sweep."""
    from opticomlib_tpu_torch.parallel.fiber import make_mesh
    spec = link.LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=-18.0,
                         pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                         pd_BW=7.5e9, include_shot=False)
    prog = link.build_link(spec, 2**12, SimParams.create(
        sps=16, R=10e9, _warn=False), device=cuda_device)
    bits = prbs(15, length=4 * 2**12)[0].reshape(4, -1)
    plain = prog.dsp_wdm(4, bits=bits, seed=3)
    meshed = prog.dsp_wdm(4, bits=bits, seed=3,
                          mesh=make_mesh([0], ("wdm",)))
    np.testing.assert_array_equal(meshed.n_errors, plain.n_errors)
    np.testing.assert_array_equal(meshed.threshold, plain.threshold)


def test_pd_after_fiber_mesh_on_card(cuda_device, nccl_mesh):
    """A staged device after FIBER(mesh=) takes the whole field on the
    card."""
    from opticomlib_tpu_torch.signals import OpticalSignal
    gv.default()
    gv(sps=16, R=10e9, N=2**16)
    x = OpticalSignal(_launch_field(2**20, 9, cuda_device))
    kw = dict(length=10, alpha=0.2, beta_2=-20.0, gamma=1.3, phi_max=0.05)
    got = devices.PD(devices.FIBER(x, mesh=nccl_mesh, **kw), BW=7.5e9,
                     include_noise="none")
    want = devices.PD(devices.FIBER(x, **kw), BW=7.5e9, include_noise="none")
    assert got.device.type == "cuda"
    a, b = got.to_numpy(), want.to_numpy()
    assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b))
    gv.default()


def test_laser_walk_same_bits_every_call(cuda_device):
    """The Wiener walk at 2^24 samples, and a link with a laser linewidth,
    give the same bits on every call with the same seed (torch's CUDA
    cumsum of one long run does not)."""
    from opticomlib_tpu_torch.ops import noise
    walks = [noise.wiener_phase(2**24, 2e-3, torch.Generator(
        device=cuda_device).manual_seed(7)) for _ in range(3)]
    assert all(torch.equal(w, walks[0]) for w in walks[1:])
    spec = link.LinkSpec(Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
                         pulse_shape="gaussian", loss_dB=3, ER_dB=26,
                         pd_BW=7.5e9, lw=1e5, rin=-150.0)
    prog = link.build_link(spec, 2**18, SimParams.create(
        sps=16, R=10e9, _warn=False), device=cuda_device)
    bits = torch.as_tensor(prbs(15, length=2**18)[0].astype(np.float32),
                           device=cuda_device)
    assert torch.equal(prog(bits, seed=3)[0], prog(bits, seed=3)[0])


_PIPE_STAGES = {
    "o4_dbp": (link.RepeatSpec(4, (link.FiberSpec(
        length=20.0, alpha=0.2, beta_2=-21.0, gamma=1.3, method="o4",
        h=5.0), link.EDFASpec(G=4.0, NF=5.0))), link.RepeatSpec(4, (
            link.DBPSpec(length=20.0, alpha=0.2, beta_2=-21.0, gamma=1.3,
                         method="o4", h=5.0, undo_gain_dB=4.0),))),
    "adaptive_bw": (link.FiberSpec(length=20.0, alpha=0.2, beta_2=-21.0,
                                   gamma=1.3, phi_max=0.01),
                    link.EDFASpec(G=4.0, BW=60e9), link.DMSpec(D=420.0),
                    link.BPFSpec(BW=80e9)),
}


@pytest.mark.parametrize("name", sorted(_PIPE_STAGES))
def test_pipelined_link_on_card(cuda_device, nccl_mesh, name):
    """build_link(span_mesh=) at world size 1 over NCCL, 2 channels of 2^16
    bits x 16, against the sequential LinkProgram.dsp_wdm on the CPU on the
    same draws: errors equal, every channel's eye scalars within 1e-4 (the
    two programs differ by 1e-6 on one device, the rest is the card against
    the CPU); the kicks, products and histograms through the kernels.  No
    ADC: its codes move by a level where the two devices' round-off puts a
    sample across a boundary (chip_smoke.py phase 5), which moves the
    spreads by 1e-3."""
    from opticomlib_tpu_torch.parallel import make_span_mesh
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=10.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=_PIPE_STAGES[name])
    params = SimParams.create(sps=16, R=10e9, _warn=False)
    n_bits, n = 2**16, 2**20
    rng = np.random.default_rng(8)
    noise = [{"ase": [rng.standard_normal((4, n), dtype=np.float32)
                      for _ in range(4)],
              "thermal": rng.standard_normal(n, dtype=np.float32),
              "shot": rng.standard_normal(n, dtype=np.float32)}
             for _ in range(2)]
    mesh = make_span_mesh(1)
    assert mesh.device.type == "cuda"
    kernels.reset_launches()
    g = link.build_link(spec, n_bits, params, span_mesh=mesh).dsp_wdm(
        2, seed=0, noise=noise, sps_resamp=128)
    launches = dict(kernels.LAUNCHES)
    c = link.build_link(spec, n_bits, params, device="cpu").dsp_wdm(
        2, bits=g.tx, seed=0, noise=noise, sps_resamp=128)
    np.testing.assert_array_equal(g.n_errors, c.n_errors)
    for k in ("threshold", "mu0", "mu1", "s0", "s1"):
        np.testing.assert_allclose(getattr(g, k), getattr(c, k), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in ("nl_halfstep", "cmul", "histogram2d"):
        assert launches[k] > 0, launches


def test_span_pipeline_on_card(cuda_device, nccl_mesh):
    """span_pipeline at world size 1 on the card: the spans one after
    another (keyed ASE drawn on the card, replayed by hand)."""
    from opticomlib_tpu_torch.ops import ssfm
    from opticomlib_tpu_torch.parallel import make_span_mesh, span_pipeline
    from opticomlib_tpu_torch.ops.noise import keyed_generator
    A = torch.stack([_field((2**18,), s, cuda_device) for s in (1, 2)])
    fs, L = 160e9, 5.0
    out = span_pipeline(A, make_span_mesh(1), fs, L, alpha=0.2,
                        beta_2=-21.0, gamma=1.3, h=None, phi_max=0.02,
                        NF=5.0, seed=4)
    assert out.local.device.type == "cuda" and out.shape == (2, 2**18)
    w = 2 * np.pi * np.fft.fftfreq(2**18) * fs
    from scipy.constants import c as c_light
    from opticomlib_tpu_torch.ops.noise import ase_sigma
    sigma = float(np.float32(ase_sigma(1.0, 5.0, c_light / 1550e-9, fs)))
    for m in range(2):
        y, _ = ssfm.ssfm_propagate(A[m], w, L, alpha=0.2, beta_2=-21.0,
                                   gamma=1.3, phi_max=0.02)
        d = torch.randn((2, 2**18), generator=keyed_generator(
            cuda_device, 4, m, 0), device=cuda_device) * sigma
        y = y * float(np.float32(10 ** 0.05)) + torch.complex(d[0], d[1])
        err = (out.local[m] - y).abs().max() / y.abs().max()
        assert float(err) <= 5e-4


def test_profiling_trace_on_card(cuda_device, tmp_path):
    """The Chrome trace of a block holds the named region and the kernels'
    names; DeviceTimer agrees with CUDA events."""
    import glob
    import json

    from opticomlib_tpu_torch.ops import ssfm
    from opticomlib_tpu_torch.utils import profiling
    n = 2**20
    A = _launch_field(n, 1, cuda_device)
    w = 2 * np.pi * np.fft.fftfreq(n) * 160e9
    kw = dict(alpha=0.2, beta_2=-20, gamma=1.3, h=0.5)
    ssfm.ssfm_propagate(A, w, 4.0, **kw)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ssfm"):
            ssfm.ssfm_propagate(A, w, 4.0, **kw)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
    assert "ssfm" in names
    assert any("_nl_halfstep_kernel" in nm for nm in names)
    assert any("cmul" in nm for nm in names)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profiling.DeviceTimer(cuda_device) as t:
        start.record()
        out, _ = ssfm.ssfm_propagate(A, w, 40.0, **kw)
        end.record()
        t.sync(out)
    ev_ms = start.elapsed_time(end)
    assert abs(t.elapsed * 1e3 - ev_ms) <= 0.05 * ev_ms + 0.2
    stats = profiling.profiled("80 steps", lambda: ssfm.ssfm_propagate(
        A, w, 40.0, **kw), out=lambda line: None)
    assert stats["n_ops"] > 0 and 0 < stats["busy_s"] <= stats["wall_s"]
    assert any("_nl_halfstep_kernel" in nm for nm in stats["by_name"])


def test_span_holds_its_kernel_launch_on_card(cuda_device):
    """Spans and the CUDA trace share one clock on the card: a span around
    one kernel launch holds the launch's runtime event, and the join of
    spans and trace (perfbench.pbcore.spans) gives the kernel to that span
    by its correlation id, the read-back after it to the enclosing one."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from opticomlib_tpu_torch.utils import profiling
    from perfbench.pbcore import spans
    A = _field((2**20,), 1, cuda_device)
    E = _field((2**20,), 2, cuda_device)
    float(kernels.cmul(A, E).abs().sum())
    profiling.record(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            on = time.time_ns()
            with profiling.span("call.card"):
                with profiling.span("launch"):
                    C = kernels.cmul(A, E)
                total = float(C.abs().sum())
            off = time.time_ns()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    assert total > 0
    ev = spans._events(prof)
    (span,) = [r for r in recs if r["name"] == "launch"]
    (kern,) = [e for e in ev if e[1] and "cmul" in e[0]]
    # cudaLaunchKernel, and the cuLaunchKernel under it where traced
    hosts = [e for e in ev if not e[1] and e[4] == kern[4]]
    assert any("LaunchKernel" in h[0] for h in hosts), hosts
    for h in hosts:
        assert span["t0_ns"] <= h[2] and h[3] <= span["t1_ns"], (
            h[0], h[2] - span["t0_ns"], h[3] - span["t1_ns"])
    cut = spans.by_span(prof, recs, (on, off))
    assert cut["calls"] == 1
    assert cut["launches_by_span"]["launch"] == 1
    assert cut["readbacks_by_span"] == {"call.card": 1}
    assert spans.UNLINKED not in cut["busy_by_span"]


def _eye_input(rows, n, sps, device, seed):
    """``(rows, n)`` float32 eye waveforms on ``device``: NRZ smoothed over
    half a slot, levels 0.05 and 0.95, Gaussian noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (rows, n // sps), generator=g, device=device)
    x = bits.to(torch.float32).repeat_interleave(sps, dim=1)
    k = torch.full((1, 1, sps // 2), 2.0 / sps, device=device)
    x = torch.nn.functional.conv1d(x[:, None], k, padding="same")[:, 0]
    return 0.05 + 0.9 * x + 0.07 * torch.randn(
        x.shape, generator=g, device=device)


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0))


@pytest.fixture
def fresh_graphs(monkeypatch):
    """The receiver's graph cache and counter, empty for one test."""
    from collections import OrderedDict

    from opticomlib_tpu_torch.ops import eyeana
    monkeypatch.setattr(eyeana, "_graphs", OrderedDict())
    monkeypatch.setattr(eyeana, "_no_graph", set())
    monkeypatch.setattr(eyeana, "GRAPH_COUNTS",
                        dict(captured=0, replayed=0, eager=0))
    return eyeana


@pytest.mark.parametrize("rows,n,sps", [(1, 2**19, 64), (1, 2**17, 16),
                                        (16, 2**17, 16)])
def test_eye_graph_replays_bit_equal_to_eager(cuda_device, fresh_graphs,
                                              rows, n, sps):
    """The eye of both cells' shapes (8192 slots at sps 64 or 16,
    resampled to 128) and of a 16-channel sweep: the first call eager, the
    second captures, the rest replay; every packed scalar of a capture and
    of a replay equals the eager call's bit for bit, a replay on a new input
    gives that input's eager answers, and each replay counts its histogram
    launch."""
    eyeana = fresh_graphs
    x, x2 = (_eye_input(rows, n, sps, cuda_device, s) for s in (1, 2))
    hows, got = [], []
    for inp in (x, x, x, x2, x):
        e = eyeana.eye_scalars(inp[0] if rows == 1 else inp, sps, 8192, 128)
        hows.append(e.how)
        got.append(e.rows.clone())
    assert hows == ["eager", "capture", "replay", "replay", "replay"]
    assert eyeana.GRAPH_COUNTS == dict(captured=1, replayed=3, eager=1)
    assert kernels.LAUNCHES["histogram2d"] == 5
    want2 = eyeana._scalar_rows(x2, sps, 8192, 128)[1]
    torch.cuda.synchronize()
    assert got[0].shape == (rows, 21)
    for g in (got[1], got[2], got[4]):
        assert _same(g, got[0])
    assert _same(got[3], want2) and not _same(got[3], got[0])


def _eye_fields_equal(a, b) -> bool:
    """Every field of two ``Eye`` objects equal, NaN to NaN, but the wall
    time."""
    if a.__dict__.keys() != b.__dict__.keys():
        return False
    for k, u in a.__dict__.items():
        v = b.__dict__[k]
        if k == "execution_time":
            continue
        if isinstance(u, np.ndarray):
            if not np.array_equal(u, v, equal_nan=True):
                return False
        elif not (u == v or (u is None and v is None)
                  or (isinstance(u, float) and np.isnan(u) and np.isnan(v))):
            return False
    return True


def test_staged_eye_replays_bit_equal_to_eager(cuda_device, fresh_graphs):
    """``GET_EYE`` at the staged cell's eye shape (8192 slots at sps 64,
    resampled to 128): the first call runs eagerly, the second captures,
    the rest replay; every scalar and trace of a capture's and a replay's
    ``Eye`` equals the eager one, and a replay on a new input gives that
    input's eager ``Eye``; the page-locked read-back gives the values
    ``eye_metrics`` reads back plainly."""
    from opticomlib_tpu_torch.signals import ElectricalSignal
    gv.default()
    gv(sps=64, R=10e9, N=2**13, device="cuda")
    try:
        x, x2 = (ElectricalSignal(
            _eye_input(1, 2**19, 64, cuda_device, s)[0].double())
            for s in (1, 2))
        eyes = [devices.GET_EYE(inp, nslots=8192, sps_resamp=128)
                for inp in (x, x, x, x2)]
        plain = fresh_graphs.eye_metrics(x._total(), 64, 8192, 128)
        assert fresh_graphs.GRAPH_COUNTS == dict(captured=1, replayed=2,
                                                 eager=1)
        fresh_graphs._graphs.clear()
        fresh_graphs.GRAPH_COUNTS["eager"] = 0
        eager2 = devices.GET_EYE(x2, nslots=8192, sps_resamp=128)
        assert fresh_graphs.GRAPH_COUNTS["eager"] == 1
    finally:
        gv.default()
    assert eyes[0].y.shape == (2**20,)
    for k in ("y", "y_top", "top_int"):      # the page-locked read-back
        assert np.array_equal(getattr(eyes[0], k), plain[k].cpu().numpy(),
                              equal_nan=True)
    assert eyes[0].mu1 == float(plain["mu1"])
    for e in eyes[1:3]:
        assert _eye_fields_equal(e, eyes[0])
    assert _eye_fields_equal(eyes[3], eager2)
    assert not _eye_fields_equal(eyes[3], eyes[0])


def test_dsp_receiver_replays_its_eye_and_reads_back_once(
        cuda_device, fresh_graphs):
    """``dsp`` at the ``ook_50km`` cell's eye shape (8192 slots at sps 64,
    resampled to 128): the third call replays the eye's graph, as one graph
    launch inside the ``rx.eye`` span with no device-to-host copy there,
    and the whole receiver reads back once; its answers equal the eager
    first call's."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from opticomlib_tpu_torch.utils import profiling
    from perfbench.pbcore import spans
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=-18.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9)
    prog = link.build_link(spec, 2**13, SimParams.create(
        sps=64, R=10e9, _warn=False), device=cuda_device)
    bits = prbs(15, length=2**13)[0]
    first = [prog.dsp(bits=bits, seed=3) for _ in range(2)]
    profiling.record(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            on = time.time_ns()
            res = prog.dsp(bits=bits, seed=3)
            off = time.time_ns()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    assert fresh_graphs.GRAPH_COUNTS == dict(captured=1, replayed=1,
                                             eager=1)
    (eye_span,) = [r for r in recs if r["name"] == "rx.eye"]
    assert eye_span["attrs"]["graph"] == "replay"
    cut = spans.by_span(prof, recs, (on, off))
    assert cut["calls"] == 1
    assert {k: v for k, v in cut["readbacks_by_span"].items()
            if k.startswith("rx.")} == {"rx.readback": 1}
    graph_launches = [
        e for e in spans._events(prof) if not e[1] and "GraphLaunch" in e[0]
        and eye_span["t0_ns"] <= e[2] and e[3] <= eye_span["t1_ns"]]
    assert len(graph_launches) == 1, graph_launches
    for r in first:
        assert (r.n_errors, r.threshold, r.rin_ok) == (
            res.n_errors, res.threshold, res.rin_ok)
        for k in ("mu0", "mu1", "s0", "s1", "t_opt", "i", "er", "eye_h",
                  "threshold_plateau", "y_left", "y_right"):
            a, b = getattr(r.eye, k), getattr(res.eye, k)
            assert a == b or (a is None and b is None) or (
                np.isnan(a) and np.isnan(b)), k
        assert np.array_equal(r.eye.top_int, res.eye.top_int)


def test_dsp_ppm_hard_replays_its_eye_and_reads_back_once(
        cuda_device, fresh_graphs):
    """``dsp_ppm(8, "hard")`` at the ``ppm8_20km`` cell's eye shape (8192
    slots at sps 32, unresampled; a 1-in-8 waveform): the third call
    replays the eye's graph inside the ``rx.eye`` span, the ``call.dsp_ppm``
    root holds the call, the receiver reads back once (``n_repaired`` with
    the rest), and the answers equal the eager first call's."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from opticomlib_tpu_torch.utils import profiling
    from perfbench.pbcore import spans
    spec = link.LinkSpec(
        Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=-19.0,
        pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
        stages=(link.BPFSpec(BW=15e9),))
    n_sym = 2**11
    prog = link.build_link(spec, n_sym * 8, SimParams.create(
        sps=32, R=10e9, _warn=False), device=cuda_device)
    bits = prbs(15, length=n_sym * 3)[0]
    first = [prog.dsp_ppm(8, "hard", bits=bits, seed=3) for _ in range(2)]
    profiling.record(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            on = time.time_ns()
            res = prog.dsp_ppm(8, "hard", bits=bits, seed=3)
            off = time.time_ns()
        recs = profiling.drain()
    finally:
        profiling.record(False)
    assert fresh_graphs.GRAPH_COUNTS == dict(captured=1, replayed=1,
                                             eager=1)
    (eye_span,) = [r for r in recs if r["name"] == "rx.eye"]
    assert eye_span["attrs"]["graph"] == "replay"
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "call.dsp_ppm"
    assert root["attrs"]["n_repaired"] == res.n_repaired > 0
    cut = spans.by_span(prof, recs, (on, off))
    assert cut["calls"] == 1
    assert {k: v for k, v in cut["readbacks_by_span"].items()
            if k.startswith("rx.")} == {"rx.readback": 1}
    for r in first:
        assert (r.n_errors, r.n_repaired, r.threshold, r.rin_ok) == (
            res.n_errors, res.n_repaired, res.threshold, res.rin_ok)
        for k in ("mu0", "mu1", "s0", "s1", "threshold_plateau"):
            assert getattr(r.eye, k) == getattr(res.eye, k), k


def _fbg_inputs(n, kL, apodization, F, device):
    """The ``fbg_rk4`` arguments of a grating over n bins of the staged
    chain's grid (fs = 640 GHz, f0 at 1550 nm), made by the code
    ``devices.FBG`` runs; the step count is the last."""
    from scipy.constants import c, pi
    fs, f0 = 640e9, c / 1550e-9
    lam = 2 * pi * c / (2 * pi * np.fft.fftshift(np.fft.fftfreq(n, 1 / fs))
                        + 2 * pi * f0)
    lam_D, L, dneff, vdneff = devices._fbg_resolve_geometry(
        1.45, 1.0, None, f0, kL, None, None, None, 1e-4)
    return devices._fbg_rk4_inputs(lam, 1.45, lam_D, L, dneff, vdneff,
                                   apodization, F, device)


@pytest.mark.parametrize("kL,apodization,F", [(2.0, "uniform", 0.0),
                                              (8.0, "gaussian", 10.0)])
def test_fbg_rk4_kernel_matches_plain(cuda_device, kL, apodization, F):
    """The kernel against the plain loop on the card: R and S to 1e-4 of
    their peak, H = S/R to 1e-4 (float32 over hundreds of RK4 steps; the
    kernel may contract a product and a sum into one fma)."""
    args = _fbg_inputs(2**16 + 3, kL, apodization, F, cuda_device)
    R, S = kernels.fbg_rk4(*args)
    assert kernels.LAUNCHES["fbg_rk4"] == 1
    Rr, Sr = kernels.fbg_rk4_ref(*args)
    torch.cuda.synchronize()
    for a, b in ((R, Rr), (S, Sr)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert float((S / R - Sr / Rr).abs().max()) <= 1e-4
    if apodization == "uniform":  # the Bragg peak reflects tanh(kL)
        assert abs(float((S / R).abs().max()) - np.tanh(kL)) < 1e-3


def test_fbg_on_card_matches_cpu(cuda_device):
    gv(sps=64, R=10e9, N=2**10, device="cuda")
    try:
        r = np.random.default_rng(2)
        x = r.normal(size=2**16) + 1j * r.normal(size=2**16)
        kw = dict(fc=gv.f0, vdneff=1e-4, kL=2.0, print_params=False,
                  retH=True)
        card, H = devices.FBG(devices.OpticalSignal(x), **kw)
        assert kernels.LAUNCHES["fbg_rk4"] == 1
        gv(sps=64, R=10e9, N=2**10, device="cpu")
        cpu, Hc = devices.FBG(devices.OpticalSignal(x), **kw)
        np.testing.assert_allclose(H, Hc, rtol=0, atol=1e-4)
        np.testing.assert_allclose(card.signal.cpu().numpy(),
                                   cpu.signal.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(x).max())
    finally:
        gv.default()


def test_trajectory_on_card_matches_cpu(cuda_device):
    gv(sps=16, R=10e9, N=2**12, device="cuda")
    try:
        t = np.arange(2**16)
        x = 0.15 * np.exp(-((t - 2**15) / 400.0) ** 2) + 0j
        kw = dict(length=20, alpha=0.2, beta_2=-21, gamma=1.3, phi_max=0.05)
        z, A = devices.FIBER(devices.OpticalSignal(x), return_steps=True,
                             **kw)
        assert A.device.type == "cuda" and A.shape == (z.size, x.size)
        assert kernels.LAUNCHES["nl_halfstep"] == z.size - 1
        gv(sps=16, R=10e9, N=2**12, device="cpu")
        zc, Ac = devices.FIBER(devices.OpticalSignal(x), return_steps=True,
                               **kw)
        assert z.size == zc.size
        np.testing.assert_allclose(z, zc, rtol=0, atol=1e-5 * 20)
        np.testing.assert_allclose(A.cpu().numpy(), Ac.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(x).max())
    finally:
        gv.default()


def test_get_eye_host_engine_on_card_signal(cuda_device):
    """engine="host" takes a card signal to the host; it agrees with the
    device engine on the card to 2e-4."""
    gv(sps=16, R=10e9, N=2**11, device="cuda")
    try:
        r = np.random.default_rng(4)
        x = np.repeat(r.integers(0, 2, 2**11), 16).astype(float)
        k = np.exp(-0.5 * (np.arange(-32, 33) / 4.8) ** 2)
        x = np.convolve(x, k / k.sum(), mode="same") + 0.05 * r.normal(
            size=x.size)
        sig = devices.ElectricalSignal(x)
        h = devices.GET_EYE(sig, nslots=1024, engine="host")
        d = devices.GET_EYE(sig, nslots=1024, engine="device")
        for key in ("mu0", "mu1", "s0", "s1", "threshold", "t_opt"):
            assert getattr(d, key) == pytest.approx(getattr(h, key),
                                                    rel=2e-4, abs=2e-5), key
    finally:
        gv.default()


def test_bench_cuda_small_on_card(cuda_device, tmp_path):
    """bench_cuda.py --small --all on the card: its JSON line and file have
    the ten cells, every number finite, no bit in error, the card named."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "bench_all.json"
    run = subprocess.run(
        [sys.executable, os.path.join(root, "bench_cuda.py"), "--small",
         "--all", "--out", str(out)], cwd=root, capture_output=True,
        text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["metric"] == "ssfm_2e24_ook_throughput" and line["value"] > 0
    detail = line["detail"]
    assert detail["device"]["torch_name"] == torch.cuda.get_device_name(0)
    assert detail["device"]["power_limit"]
    rows = json.loads(out.read_text())
    assert len(rows) == 11 and rows["device"] == detail["device"]
    for k, row in rows.items():
        if k == "device":
            continue
        assert np.isfinite(row["samples_per_s"]) and row["samples_per_s"] > 0
        assert row["peak_mem_gib"] > 0 and min(row["walls_s"]) > 0, k
    assert rows["config2_full_dsp"]["ber"] == 0.0
    assert rows["config3_ppm8_chain"]["ber"] == 0.0
    assert rows["config5_wdm16_per_chip"]["max_ber"] == 0.0
    assert rows["config4_dbp_o4_roundtrip"]["fft_pairs"] == 48
