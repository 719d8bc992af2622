"""Build and load the CUDA C++ kernels (``ops/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with ``ctypes``;
PyTorch's headers stay out, so a build takes seconds, and :func:`build`
starts one ``nvcc`` per source, all at once.  The libraries land in
``build/kernels/`` at the repository root, named by the source and a hash of
its text and the flags, so an edited source is rebuilt and an unchanged one
is reused.  The compiler's report (``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``<name>.log``.  The same
compile-and-cache step (:func:`compiled_library`) builds the port's C++ host
helpers (``native/``) with ``g++`` into ``build/native/``.
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
        "cmul_launch": [_P, _P, _P, _LL, _LL, _I, _P],
        "spectral_phase_launch": [_P, _P, _LL, _LL, _F, _F, _P],
        "cmul_max_launch": [_P, _P, _P, _LL, _P, _P, _P],
        "power_max_launch": [_P, _LL, _P, _P, _P]},
    "histogram2d": {
        "histogram_scratch_len": [_I, _I, _I],
        "histogram_rows_launch": [_P, _I, _LL, _I, _P, _LL, _P, _I, _P],
        "histogram2d_launch": [_P, _P, _LL, _I, _I, _P, _LL, _P, _I, _P]},
    "adc_quantize": {
        "adc_kernel_launch": [_P, _P, _LL, _F, _F, _I, _I, _ULL, _P],
        "adc_link_launch": [_P, _P, _LL, _P, _P, _F, _P]},
    "fir_filter": {
        "fir_launch": [_P, _P, _P, _LL, _I, _P]},
    "pencil": {
        "pencil_dft_launch": [_P, _P, _P, _P, _I, _LL, _LL, _P],
        "pencil_twiddle_pack_launch": [_P, _P, _P, _I, _LL, _LL, _P]},
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


def cached_path(src: Path, flags, out_dir: Path, name: str) -> Path:
    """Where the library built from ``src`` with ``flags`` lives (built or
    not): ``out_dir``, named by ``name`` and a hash of the flags and the
    source's text."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return out_dir / f"libopticomlib_{name}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives (built or not)."""
    return cached_path(_CSRC / f"{name}.cu", NVCC_FLAGS, BUILD_DIR, name)


def _start(compiler: str, flags, src: Path, path: Path) -> tuple:
    """Start compiling ``src`` into a temporary name beside ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    return cmd, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(path: Path, job: tuple, timeout: float):
    """Wait for the compile ``job`` of :func:`_start`; keep its report as
    ``<path>.log`` and move the library into ``path`` (atomic: never a torn
    library).  Returns None, or what went wrong."""
    cmd, tmp, proc = job
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
    path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"{Path(cmd[-1]).name}: {Path(cmd[0]).name} exit "
                f"{proc.returncode}\n{log}")
    os.replace(tmp, path)
    return None


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
    nvcc = _nvcc()
    jobs = {name: _start(nvcc, NVCC_FLAGS, _CSRC / f"{name}.cu", path)
            for name, path in todo.items()}
    failed = [e for e in (_finish(todo[name], job, 600)
                          for name, job in jobs.items()) if e]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def compiled_library(compiler: str, flags, src: Path, out_dir: Path,
                     name: str, timeout: float = 120) -> ctypes.CDLL:
    """Load the library built from the one source ``src`` with ``compiler``
    and ``flags``, compiling it into ``out_dir`` first if it is not there
    (:func:`cached_path`).  Raises ``OSError`` when the compiler is missing
    or the library does not load, ``RuntimeError`` when the compile
    fails."""
    path = cached_path(src, flags, out_dir, name)
    if not path.is_file():
        err = _finish(path, _start(compiler, flags, src, path), timeout)
        if err:
            raise RuntimeError(err)
    return ctypes.CDLL(str(path))


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
