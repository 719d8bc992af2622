"""The port stands alone: importing every module of opticomlib_tpu_torch
imports neither JAX nor the JAX package, and asking for a CUDA device
without a card raises instead of falling back to the CPU (``build_link``
and ``gv(device=...)`` alike)."""
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

_MODULES = ("opticomlib_tpu_torch", "opticomlib_tpu_torch.link",
            "opticomlib_tpu_torch.link_sharded",
            "opticomlib_tpu_torch.convert", "opticomlib_tpu_torch.eyediag",
            "opticomlib_tpu_torch.params", "opticomlib_tpu_torch.ops.kernels",
            "opticomlib_tpu_torch.ops._build",
            "opticomlib_tpu_torch.ops.ssfm",
            "opticomlib_tpu_torch.ops.eyeana", "opticomlib_tpu_torch.ops.noise",
            "opticomlib_tpu_torch.ops.filters",
            "opticomlib_tpu_torch.ops.pulses", "opticomlib_tpu_torch.ops.prbs",
            "opticomlib_tpu_torch.utils.analysis",
            "opticomlib_tpu_torch.utils.theory", "opticomlib_tpu_torch.rng",
            "opticomlib_tpu_torch.signals", "opticomlib_tpu_torch.devices",
            "opticomlib_tpu_torch.ook", "opticomlib_tpu_torch.models.ook",
            "opticomlib_tpu_torch.ppm", "opticomlib_tpu_torch.models.ppm",
            "opticomlib_tpu_torch.runtime",
            "opticomlib_tpu_torch.runtime.checkpoint",
            "opticomlib_tpu_torch.utils.profiling",
            "opticomlib_tpu_torch.parallel",
            "opticomlib_tpu_torch.parallel.multihost",
            "opticomlib_tpu_torch.parallel.halo",
            "opticomlib_tpu_torch.parallel.dfft",
            "opticomlib_tpu_torch.parallel.fiber",
            "opticomlib_tpu_torch.parallel.pipeline",
            "opticomlib_tpu_torch.link_pipeline",
            "opticomlib_tpu_torch.logger", "opticomlib_tpu_torch.lab")


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'opticomlib_tpu.'))\n"
        "             or m == 'opticomlib_tpu')\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_device_without_card_raises(monkeypatch):
    from opticomlib_tpu_torch import LinkSpec, SimParams, build_link
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_link(LinkSpec(), 16, SimParams.create(sps=8, R=1e9,
                                                    _warn=False),
                   device="cuda")


def test_gv_cuda_device_without_card_raises(monkeypatch):
    from opticomlib_tpu_torch import gv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gv(device="cuda")
    finally:
        gv.default()
