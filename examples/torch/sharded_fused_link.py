"""Sharded fused link on PyTorch: the whole TX -> channel -> RX chain over a
('wdm', 'time') mesh of ``torch.distributed`` ranks, through the public
API; twin of examples/sharded_fused_link.py.

One rank a card (NCCL), or a CPU process with ``--device cpu`` (gloo).
Alone it is one rank, world size 1; under torchrun it takes the ranks it is
given.  The meshes follow the JAX script's 8-device meshes where the world
size divides them: 4 channels over gcd(world, 4) 'wdm' ranks and the rest
of the world on 'time' ((4, 2) at 8 ranks, (1, 1) alone), then every rank
on one 'time' axis for a single long channel.

Run:  python examples/torch/sharded_fused_link.py [--device cpu]
      torchrun --nproc-per-node=8 examples/torch/sharded_fused_link.py
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
import math
import os
import socket

import numpy as np
import torch.distributed as dist

from opticomlib_tpu_torch.link import (EDFASpec, FiberSpec, LinkSpec,
                                       build_link)
from opticomlib_tpu_torch.params import SimParams
from opticomlib_tpu_torch.parallel import initialize_multihost
from opticomlib_tpu_torch.parallel.fiber import make_mesh

ap = argparse.ArgumentParser(description="sharded fused link")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

if "WORLD_SIZE" in os.environ:      # under torchrun
    world = initialize_multihost(device=args.device)
else:                               # alone: one rank
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                                 device=args.device)
say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

params = SimParams.create(sps=16, R=10e9, _warn=False)
spec = LinkSpec(
    pulse_shape="gaussian", Vpp=5, offset=-2.5, bias=-2.5, Vpi=5,
    P0=5, loss_dB=3, ER_dB=26,
    stages=(FiberSpec(length=50, alpha=0.2, beta_2=-21.0, gamma=1.3),
            EDFASpec(G=10, NF=5)),
    pd_BW=7.5e9,
)

# --- 4 WDM channels x time-sharded waveforms over a ('wdm', 'time') mesh ---
n_wdm = math.gcd(world, 4)
mesh = make_mesh(np.arange(world).reshape(n_wdm, world // n_wdm),
                 ("wdm", "time"))
prog = build_link(spec, n_bits=2**12, params=params, mesh=mesh)

sweep = prog.dsp_wdm(4, seed=0)     # receivers on the ranks, scalars back
say("mesh:", dict(mesh.shape))
say("per-channel BER:      ", sweep.ber)
say("per-channel threshold:", np.round(sweep.threshold, 4))

# --- every rank on the time axis for one long channel ---
mesh_t = make_mesh(range(world), ("time",))
prog_t = build_link(spec, n_bits=2**13, params=params, mesh=mesh_t)
r = prog_t.dsp(seed=1)
say(f"time-sharded single channel: BER={r.ber}  ER={r.eye.er:.1f} dB")
assert r.ber == prog_t.dsp(seed=1).ber  # keyed noise: bit-reproducible
