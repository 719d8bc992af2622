"""Pipeline-parallel multi-span link on PyTorch; twin of
examples/span_pipeline_link.py.

Each rank owns one fiber span (+ transparent EDFA); a batch of independent
waveforms (WDM channels / Monte-Carlo shots) streams through the spans as
pipeline microbatches, point to point between the ranks.  One rank a card
(NCCL), or a CPU process with ``--device cpu`` (gloo): S = min(4, world)
spans, as the JAX script's min(4, devices); alone it is one rank and one
span, under torchrun with 2 to 4 ranks each rank owns a span (every rank
must be in the span mesh).

Run:  python examples/torch/span_pipeline_link.py [--device cpu]
      torchrun --nproc-per-node=4 examples/torch/span_pipeline_link.py
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
import torch.distributed as dist

from opticomlib_tpu_torch.parallel import initialize_multihost
from opticomlib_tpu_torch.parallel.pipeline import (make_span_mesh,
                                                    span_pipeline)

ap = argparse.ArgumentParser(description="span-pipelined link")
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

S = min(4, world)                   # spans == ranks
B, n, fs = 8, 4096, 160e9

rng = np.random.default_rng(0)
bits = rng.integers(0, 2, (B, n // 16))
A = (np.repeat(bits, 16, axis=-1) * np.sqrt(0.01)).astype(np.complex64)

out = span_pipeline(A, make_span_mesh(S), fs=fs, span_length=80.0,
                    alpha=0.2, beta_2=-21.0, gamma=1.3, h=1.0)
out = np.asarray(out)               # every rank gathers the batch

say(f"{S}-span x 80 km link, {B} microbatches of {n} samples")
say(f"pipeline utilization: {B / (B + S - 1):.0%}")
say(f"mean output power:    {np.mean(np.abs(out) ** 2) * 1e3:.3f} mW "
    f"(transparent link, input {np.mean(np.abs(A) ** 2) * 1e3:.3f} mW)")

# ---------------------------------------------------------------------
# The public pipelined fused link: the same capability through the
# LinkSpec vocabulary.  build_link(span_mesh=) distributes a
# heterogeneous stage chain (here: 4x FIBER+EDFA spans followed by 4x
# per-span DBP with undo-gain, the BASELINE config-4 shape) over the
# mesh and streams a WDM batch of channels through it; TX and the
# OOK receivers run on each channel's owner rank.
# ---------------------------------------------------------------------
from opticomlib_tpu_torch.link import (  # noqa: E402
    DBPSpec, EDFASpec, FiberSpec, LinkSpec, RepeatSpec, build_link,
)
from opticomlib_tpu_torch.params import SimParams  # noqa: E402

params = SimParams.create(sps=8, R=10e9, _warn=False)
spec = LinkSpec(
    Vpp=5, offset=-2.5, bias=-2.5, Vpi=5, P0=5,
    pulse_shape="gaussian", loss_dB=3, ER_dB=26, pd_BW=7.5e9,
    stages=(
        RepeatSpec(4, (FiberSpec(length=80, alpha=0.2, beta_2=-21.0,
                                 gamma=1.3, h=1.0),
                       EDFASpec(G=16.0))),
        RepeatSpec(4, (DBPSpec(length=80, alpha=0.2, beta_2=-21.0,
                               gamma=1.3, h=1.0, undo_gain_dB=16.0),)),
    ))
prog = build_link(spec, n_bits=1024, params=params,
                  span_mesh=make_span_mesh(S))
sweep = prog.dsp_wdm(2 * S, seed=0, nslots=1024)
say(f"pipelined fused link: {2 * S} channels through 8 segments on "
    f"{S} ranks, BER = {sweep.ber.tolist()}")
