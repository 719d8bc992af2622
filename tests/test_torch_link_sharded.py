"""The port's sharded fused link (opticomlib_tpu_torch.link_sharded,
``build_link(mesh=)``, and the sweeps' ``mesh=``) on real
``torch.distributed`` CPU ranks (gloo, spawned processes), against the
port's unsharded link inside the ranks and against the JAX package's
``ShardedLinkProgram`` on a 4-device CPU mesh of the same shape here.

One launch a mesh, with all its cases inside
(tests/_torch_link_sharded_child.py), behind a module-scoped fixture: 4 ranks
as a 1-D 'time' mesh (the JAX tests' ``Mesh(devices, ("time",))``) and 4 as a
('wdm', 'time') mesh of 2 x 2.  Each case is its own test below.

Tolerances.  Against the port's unsharded link on the same ranks (checked
inside them): noiseless ``v`` within 2e-5 of the peak, the JAX tests' bound,
with equal step counts (per channel for the adaptive fiber); ``dsp``
noiseless: BER equal, threshold atol 1e-5, ``mu1`` rtol 1e-4; on injected
noise the same 2e-5; noisy runs statistically (``mu1`` and threshold within
20 %); the ADC within 1.5 LSB; the sweeps over a mesh equal the plain sweeps
(errors and steps equal, thresholds and ``mu1`` rtol 1e-6).  Against the JAX
``ShardedLinkProgram`` (checked here): noiseless ``v`` within 1e-4 of the
peak (the sharded fiber's bound), the adaptive and self-tuning step counts
equal to the JAX loops' on the JAX launch field, the constants bit for bit.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_link_sharded_child as child
from opticomlib_tpu import link as jlink
from opticomlib_tpu import params as jparams
from opticomlib_tpu.ops import ssfm as jssfm
from test_torch_parallel import _all_ranks_ok, _suite

torch.set_num_threads(2)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_link_sharded_child.py")


def _jax_mesh(shape, names):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


def _jax_params():
    return child.params_of(jparams)


def _write_jax_consts(out_dir):
    """The JAX ShardedLinkProgram's constants, for the consts case."""
    pr = jlink.build_link(child.make_spec(jlink, child.CONSTS_STAGES,
                                          df=1e9),
                          child.N_BITS, params=_jax_params(),
                          mesh=_jax_mesh((4,), ("time",)))
    np.savez(os.path.join(out_dir, "jax_consts.npz"),
             **{k: np.asarray(v) for k, v in pr.consts.items()})


@pytest.fixture(scope="module")
def t4(tmp_path_factory):
    return _suite(tmp_path_factory, "t4", _write_jax_consts, child=CHILD)


@pytest.fixture(scope="module")
def w2x2(tmp_path_factory):
    return _suite(tmp_path_factory, "w2x2", child=CHILD)


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_v(name):
    spec = child.make_spec(jlink, child.STAGE_CASES[name])
    pr = jlink.build_link(spec, child.N_BITS, params=_jax_params(),
                          mesh=_jax_mesh((4,), ("time",)),
                          return_field=name == "o4_fixed")
    return np.asarray(pr.jitted(child.BITS, np.uint32([0]))[0])[0]


def _jax_steps(name):
    """Step count of the JAX loop that the one fiber stage of ``name`` runs,
    on the JAX link's launch field; None for a fixed schedule."""
    (_, kw), = child.STAGE_CASES[name]
    pr = jlink.build_link(child.make_spec(jlink), child.N_BITS,
                          params=_jax_params(), return_field=True)
    out = pr.jitted(jnp.asarray(child.BITS), jnp.uint32(0))
    re, im = out[2], out[3]
    w = 2 * np.pi * np.fft.fftfreq(re.shape[-1]) * pr.params.fs
    phi_w = jssfm.dispersion_phase(w, kw["beta_2"], 0.0)
    a_km = jssfm.alpha_per_km(kw["alpha"])
    L, g = kw["length"], kw["gamma"]
    if kw.get("method", "reference") == "reference":
        h0 = jssfm.adaptive_h0(0.01, g, float(jnp.max(re**2 + im**2)), L)
        return int(jssfm._ssfm_loop(re, im, phi_w, L, g, 0.01, h0, a_km,
                                    adaptive=True)[2])
    loop = (jssfm._ssfm_o4_auto_loop if kw["method"] == "o4"
            else jssfm._ssfm_local_error_loop)
    return int(loop(re, im, phi_w, jnp.float32(L), jnp.float32(g),
                    jnp.float32(kw["tol"]), jnp.float32(L / 10.0),
                    jnp.float32(a_km))[2])


# ---------------------------------------------------------------------------
# a 1-D 'time' mesh of 4 ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(child.STAGE_CASES))
def test_sharded_noiseless_equals_unsharded(t4, name):
    """Inside the ranks: the port's unsharded link (2e-5, equal steps)."""
    _all_ranks_ok(t4, f"stage_{name}")


@pytest.mark.parametrize("name", sorted(child.STAGE_CASES))
def test_sharded_noiseless_matches_jax_sharded(t4, name):
    res = _all_ranks_ok(t4, f"stage_{name}")
    got = np.load(os.path.join(t4["out"], f"stage_{name}.npy"))
    want = _jax_v(name)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= 1e-4, err
    if name in ("fiber_adaptive", "o4_auto", "local_error"):
        assert res["n_steps"] == [_jax_steps(name)]


def test_sharded_dsp_noiseless_matches_jax(t4):
    _all_ranks_ok(t4, "dsp_noiseless_matches_unsharded")
    with open(os.path.join(t4["out"], "dsp_noiseless.json")) as f:
        got = json.load(f)
    spec = child.make_spec(jlink, (("fiber", dict(child._FIB, h=1.0)),))
    want = jlink.build_link(spec, 1024, params=_jax_params(),
                            mesh=_jax_mesh((4,), ("time",))).dsp(seed=3)
    assert got["ber"] == want.ber
    np.testing.assert_allclose(got["threshold"], want.threshold, atol=1e-5)
    np.testing.assert_allclose(got["mu1"], want.eye.mu1, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(child.CHECKS_T4))
def test_time_mesh(t4, name):
    _all_ranks_ok(t4, name)


# ---------------------------------------------------------------------------
# a ('wdm', 'time') mesh of 2 x 2 ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(child.CHECKS_W2X2))
def test_wdm_time_mesh(w2x2, name):
    _all_ranks_ok(w2x2, name)


def test_per_channel_adaptive_stepping_matches_jax(w2x2):
    _all_ranks_ok(w2x2, "per_channel_adaptive_stepping")
    got = np.load(os.path.join(w2x2["out"], "per_channel.npy"))
    spec = child.make_spec(jlink, (("fiber", child._FIB),))
    pr = jlink.build_link(spec, child.N_BITS, params=_jax_params(),
                          mesh=_jax_mesh((2, 2), ("wdm", "time")))
    want = np.asarray(pr.jitted(child.PER_CHANNEL_BITS,
                                np.zeros(8, np.uint32))[0])
    for c in range(8):
        err = np.max(np.abs(got[c] - want[c])) / np.max(np.abs(want[c]))
        assert err <= 1e-4, (c, err)
