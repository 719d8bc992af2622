"""The port stands alone: importing every module of opticomlib_tpu_torch
imports neither JAX nor the JAX package, no source of the port, of its
example scripts, of its ``scripts/torch_*.py``, of ``bench_cuda.py`` or of
``chip_smoke.py`` names either in an import, and asking for a CUDA device
without a card raises instead of falling back to the CPU (``build_link``
and ``gv(device=...)`` alike)."""
import ast
import glob
import os
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
            "opticomlib_tpu_torch.logger", "opticomlib_tpu_torch.lab",
            "opticomlib_tpu_torch.native")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(
    glob.glob(os.path.join(_ROOT, "opticomlib_tpu_torch", "**", "*.py"),
              recursive=True)
    + glob.glob(os.path.join(_ROOT, "examples", "torch", "*.py"))
    + glob.glob(os.path.join(_ROOT, "scripts", "torch_*.py"))
    + [os.path.join(_ROOT, "chip_smoke.py"),
       os.path.join(_ROOT, "bench_cuda.py")])


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


def test_bench_cuda_imports_no_jax():
    """The benchmark CLI, imported as a module, loads no JAX."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('bench_cuda', "
        f"{os.path.join(_ROOT, 'bench_cuda.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'opticomlib_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported(path):
    """Every module name an import statement of ``path`` names."""
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _SOURCES,
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_source_imports_jax(path):
    """The package (native/ included) and the example twins name no
    ``jax``/``jaxlib`` module and nothing of ``opticomlib_tpu`` but
    ``opticomlib_tpu_torch`` in any import, even one inside a function."""
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "opticomlib_tpu")]
    assert bad == [], (path, bad)


def test_the_scan_sees_the_twins_and_native():
    rel = {os.path.relpath(p, _ROOT) for p in _SOURCES}
    assert "opticomlib_tpu_torch/native/__init__.py" in rel
    assert sum(r.startswith("examples/torch/") for r in rel) == 15
    assert {"chip_smoke.py", "bench_cuda.py",
            "scripts/torch_calibration_common.py",
            "scripts/torch_calibrate_equal_accuracy.py",
            "scripts/torch_calibrate_dbp_o4.py",
            "scripts/torch_ber_equal_accuracy.py",
            "scripts/torch_bench_shard_crossover.py",
            "scripts/torch_gen_api_docs.py"} <= rel
    # the scan sees a JAX script's imports
    assert {"opticomlib_tpu", "opticomlib_tpu.link"} <= set(_imported(
        os.path.join(_ROOT, "examples", "fused_link.py")))


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
