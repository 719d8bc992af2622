"""Sharded WDM sweep on PyTorch: channels x time blocks over a mesh of
``torch.distributed`` ranks (BASELINE config 5, scaled to the ranks
available); twin of examples/sharded_wdm_sweep.py.

One rank a card (NCCL), or a CPU process with ``--device cpu`` (gloo).
Alone it is one rank, world size 1; under torchrun it takes the ranks it is
given, and the mesh follows the JAX script's rule: 2 channels on 'wdm' when
the world size is even and above 1, the rest on 'time' ((2, 4) at 8 ranks,
(1, 1) alone).

Run:  python examples/torch/sharded_wdm_sweep.py [--device cpu]
      torchrun --nproc-per-node=8 examples/torch/sharded_wdm_sweep.py
(on the card by default; without one, and without ``--device cpu``, it
raises)
"""
try:  # running from a source checkout without an install
    import opticomlib_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))))
import argparse
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from scipy.ndimage import gaussian_filter1d

from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.parallel import initialize_multihost
from opticomlib_tpu_torch.parallel.fiber import (make_link_mesh,
                                                 shard_waveform, ssfm_sharded)

ap = argparse.ArgumentParser(description="sharded WDM sweep")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

if "WORLD_SIZE" in os.environ:      # under torchrun
    n_dev = initialize_multihost(device=args.device)
else:                               # alone: one rank
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_dev = initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                                 device=args.device)
say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

n_wdm = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
n_time = n_dev // n_wdm
say(f"devices: {n_dev} -> mesh ('wdm'={n_wdm}, 'time'={n_time})")

FS = 160e9
N = 2**16  # scale to 2**26 on a pod slice
rng = np.random.default_rng(0)

# one waveform per WDM channel
A = np.stack([
    gaussian_filter1d(
        np.repeat(rng.integers(0, 2, N // 16).astype(float), 16), 4) * 0.2
    for _ in range(n_wdm)]).astype(np.complex64)

mesh = make_link_mesh(n_wdm=n_wdm, n_time=n_time)
A_sharded = shard_waveform(A, mesh)

kw = dict(length=20, alpha=0.2, beta_2=-21, gamma=1.3, h=0.5)
out = ssfm_sharded(A_sharded, mesh, fs=FS, **kw)  # exact pencil FFT
whole = out.whole()                                # every rank gathers

# verify channel 0 against the single-process engine
w = 2 * np.pi * np.fft.fftfreq(N) * FS
single, _ = ssfm.ssfm_propagate(torch.as_tensor(A[0], device=mesh.device),
                                w, **kw)
err = float((whole[0] - single).abs().max() / single.abs().max())
say(f"sharded vs single-device relative error: {err:.2e}")
say("powers per channel [W]:",
    [float(torch.mean(whole[c].abs() ** 2)) for c in range(n_wdm)])
