"""What the PyTorch calibration scripts share: their command line, the card
check and device record, the fixed-step 4th-order loop, the error measure,
timing and the merge into the output file.

The scripts are ``torch_calibrate_equal_accuracy.py`` (config 2),
``torch_calibrate_dbp_o4.py`` (config 4's DBP step) and
``torch_ber_equal_accuracy.py`` (the launch-power BER check), twins of the
JAX package's ``calibrate_equal_accuracy.py``, ``calibrate_dbp_o4.py`` and
``ber_equal_accuracy.py``: the same grids, targets, stopping rules, seeds
and JSON keys, run on ``opticomlib_tpu_torch``.  They write
``EQUAL_ACCURACY_CUDA.json`` at the repository root unless given ``--out``;
each merges its own entries into the file and leaves the others.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from opticomlib_tpu_torch.ops import ssfm  # noqa: E402
from opticomlib_tpu_torch.params import check_device  # noqa: E402

f32 = np.float32
DEFAULT_OUT = os.path.join(ROOT, "EQUAL_ACCURACY_CUDA.json")
#: the runaway backstop of the JAX script's fixed-step loop
MAX_STEPS = 400_000
NOTE = ("wall_s: host clock between two torch.cuda.synchronize() calls "
        "around the compute, without the host readback; the errors are "
        "computed on the device in float64")


def parse_args(argv, doc: str, sizes: dict) -> argparse.Namespace:
    """``--device`` (default ``cuda``), ``--out`` and the size flags
    ``sizes``: ``{flag: (default, help)}``, integers."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="the JSON file to merge into (default "
                        "EQUAL_ACCURACY_CUDA.json at the repository root)")
    for flag, (default, what) in sizes.items():
        p.add_argument(f"--{flag}", type=int, default=default, help=what)
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "EQUAL_ACCURACY.json"):
        p.error("EQUAL_ACCURACY.json is the JAX package's record; give "
                "another --out")
    args.device = check_device(args.device)
    return args


def device_block(device: torch.device) -> dict:
    """The device a run took its numbers on: for a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them, with
    the torch and CUDA versions."""
    block = {"type": device.type, "torch": torch.__version__,
             "cuda": torch.version.cuda}
    if device.type == "cuda":
        index = device.index or 0
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60, check=True)
        name, limit = (s.strip() for s in smi.stdout.strip().split(","))
        block.update(name=name, power_limit=limit,
                     torch_name=torch.cuda.get_device_name(index))
    else:
        block.update(name="cpu", power_limit=None)
    return block


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(device: torch.device, fn):
    """``fn()`` and its wall time between two synchronisations."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """``||x - ref|| / ||ref||`` in float64, on the tensors' device (what
    the JAX scripts compute in NumPy on the read-back fields)."""
    x, ref = x.to(torch.complex128), ref.to(torch.complex128)
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref))


def o4_fixed(A: torch.Tensor, phi_w: torch.Tensor, length, gamma, alpha,
             h):
    """Fixed-step 4th-order (Yoshida) propagation over ``length`` km, the
    JAX scripts' ``while_loop``: each step ``hh = max(min(h, length - z),
    h_floor)`` with ``h_floor = length * 1.5e-7`` and ``z`` accumulated in
    float32, three true Strang substeps of ``w1 hh``, ``w0 hh``, ``w1 hh``
    (3 FFT pairs), at most 400,000 steps.  The linear factor of each
    substep size is built once.  Returns ``(A, n_steps)``."""
    length, gamma, alpha, h = f32(length), f32(gamma), f32(alpha), f32(h)
    w1, w0 = f32(ssfm._W1), f32(ssfm._W0)
    h_floor = length * f32(1.5e-7)
    factors = {}
    z, k = f32(0.0), 0
    while z < length and k < MAX_STEPS:
        hh = max(min(h, length - z), h_floor)
        for wgt in (w1, w0, w1):
            hw = hh * wgt
            if hw not in factors:
                factors[hw] = ssfm._lin_factor(phi_w, alpha, hw)
            A = ssfm._strang_step(A, phi_w, alpha, hw, gamma, factors[hw])
        z = z + hh
        k += 1
    return A, k


def merge(path: str, entries: dict) -> None:
    """Write ``entries`` into the JSON file ``path``, keeping its other
    keys."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update(entries)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
