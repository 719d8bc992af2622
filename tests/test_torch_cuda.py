"""The port on an NVIDIA card: each hand-written kernel against its plain
PyTorch version, and the link on the card against the link on the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu_torch import link
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
def test_triton_kernels_match_plain(cuda_device, shape):
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
    v_g, v_c = rg.v.cpu().numpy(), rc.v.numpy()
    assert np.linalg.norm(v_g - v_c) / np.linalg.norm(v_c) <= 1e-4
    assert dg.n_errors == dc.n_errors
    assert abs(dg.threshold - dc.threshold) <= abs(
        dc.eye.mu1 - dc.eye.mu0) / 999 * (1 + 1e-3)
    assert kernels.LAUNCHES["histogram2d"] >= 1
    assert kernels.LAUNCHES["nl_halfstep"] >= rg.n_steps[0]
