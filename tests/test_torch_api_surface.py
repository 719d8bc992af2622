"""The port's package surface: its ``__all__`` is the JAX package's but the
compilation cache (``enable_cache``, ``cache_dir``, which have no
counterpart here), every name resolves, and the modules, functions and
constants named there are the port's own (or the same NumPy / SciPy /
logging objects the JAX package re-exports)."""
import inspect
import logging
import types

import numpy as np
import pytest

import opticomlib_tpu as J
import opticomlib_tpu_torch as T

NOT_PORTED = {"enable_cache", "cache_dir"}


def test_all_equals_jax_but_the_cache():
    assert set(J.__all__) - set(T.__all__) == NOT_PORTED
    assert set(T.__all__) - set(J.__all__) == set()
    assert len(T.__all__) == len(set(T.__all__))


@pytest.mark.parametrize("name", sorted(set(J.__all__) - NOT_PORTED))
def test_name_resolves_to_the_port(name):
    got, want = getattr(T, name), getattr(J, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ in ("numpy", f"opticomlib_tpu_torch.{name}")
    elif inspect.isfunction(want) or inspect.isclass(want):
        assert callable(got) and got.__name__ == want.__name__
        mod = getattr(got, "__module__", "")
        assert not mod.startswith("opticomlib_tpu.") and mod != \
            "opticomlib_tpu", (name, mod)
    elif name in ("Array_Like", "RealNumber", "ComplexNumber"):
        assert isinstance(got, tuple)
    else:  # constants, the NumPy re-exports, logging levels, gv, NULL
        assert type(got).__name__ == type(want).__name__
        if isinstance(want, (int, float, np.ufunc)) or name in (
                "DEBUG", "INFO", "WARNING", "fft", "ifft", "fftfreq",
                "fftshift", "ifftshift", "ndarray"):
            assert got is want or got == want


def test_lazy_plt_and_sizeof():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    assert T.plt is plt
    with pytest.raises(AttributeError):
        T.definitely_not_a_name
    arr = np.ones(1000)
    assert T.sizeof(arr) >= arr.nbytes
    assert T.sizeof({"a": arr}) >= arr.nbytes
    import torch
    assert T.sizeof([torch.ones(1000)]) >= 4000
    assert T.DEBUG == logging.DEBUG


def test_fused_link_names_stay_importable():
    """The fused link's names are importable from the package, outside
    ``__all__`` (which is the JAX package's)."""
    for name in ("BPFSpec", "DBPSpec", "DMSpec", "EDFASpec", "FiberSpec",
                 "LinkProgram", "LinkSpec", "RepeatSpec", "build_link",
                 "ShardedLinkProgram", "prbs"):
        assert hasattr(T, name)
