"""Build and load the CUDA C++ kernels (``ops/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with ``ctypes``;
PyTorch's headers stay out, so a build takes seconds, and :func:`build`
starts one ``nvcc`` per source, all at once.  The libraries land in
``build/kernels/`` at the repository root, named by the source and a hash of
its text and the flags, so an edited source is rebuilt and an unchanged one
is reused.  The compiler's report (``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float, ctypes.c_ulonglong)
#: C entry points of each source: name -> argument types (each returns int,
#: a CUDA error code, unless :data:`RESTYPES` names another type); every
#: library also exports ``error_string``
ENTRY_POINTS = {
    "cmul": {
        "cmul_launch": [_P, _P, _P, _LL, _LL, _I, _P]},
    "histogram2d": {
        "histogram_scratch_len": [_I, _I, _I],
        "histogram_rows_launch": [_P, _I, _LL, _I, _P, _LL, _P, _I, _P],
        "histogram2d_launch": [_P, _P, _LL, _I, _I, _P, _LL, _P, _I, _P]},
    "adc_quantize": {
        "adc_kernel_launch": [_P, _P, _LL, _F, _F, _I, _I, _ULL, _P],
        "adc_link_launch": [_P, _P, _LL, _P, _P, _F, _P]},
    "fir_filter": {
        "fir_launch": [_P, _P, _P, _LL, _I, _P]},
    "fbg_rk4": {
        "fbg_rk4_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F,
                           _F, _P, _P, _LL, _P]},
}
RESTYPES = {"histogram_scratch_len": _LL}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) \
            + [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "opticomlib_tpu_torch are built from source on first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives (built or not)."""
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libopticomlib_{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the sources ``names`` (default: all) that have no library
    yet, one ``nvcc`` process each, started together; returns
    ``{name: library path}``.  Raises if any compile fails."""
    names = (sorted(src.stem for src in _CSRC.glob("*.cu")) if names is None
             else list(names))
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        todo[name].with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, todo[name])  # atomic: never a torn .so
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare its C entry
    points."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for fn, argtypes in ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
