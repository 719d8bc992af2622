"""Shared helpers of the parity tests between the JAX package and its
PyTorch port: the JAX link's noise draws rebuilt along its key stream, so
the port can be fed the same numbers through ``noise=`` (the chain's normal
draws and the hard PPM receiver's uniform draws)."""
import jax
import jax.numpy as jnp
import numpy as np

from opticomlib_tpu import link as jlink


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def jax_draws(seed, n, spec):
    """Unit-normal draws of the JAX program for ``spec`` (a JAX
    ``LinkSpec``) at ``n`` samples, in its key-stream order (link.py fwd):

    * ``k_laser`` first, split into the phase and RIN keys;
    * one key per noisy EDFA, a (4, n) draw each;
    * for a ``RepeatSpec`` holding a noisy EDFA, one block key;  span ``idx``
      folds ``idx`` into it, and each noisy EDFA of the span splits the next
      key off that (link.py:702-722);
    * ``k_pd`` last, split into the thermal and shot keys.
    """
    stream = jax.random.PRNGKey(np.uint32(seed))
    stream, k_laser = jax.random.split(stream)
    k_ph, k_rin = jax.random.split(k_laser)
    out = {}
    if spec.lw and spec.lw > 0:
        out["phase"] = _normal(k_ph, (n,))
    if spec.rin is not None:
        out["rin"] = _normal(k_rin, (n,))

    def noisy(st):
        return isinstance(st, jlink.EDFASpec) and st.NF is not None

    ase = []
    for st in spec.stages:
        if noisy(st):
            stream, k = jax.random.split(stream)
            ase.append(_normal(k, (4, n)))
        elif isinstance(st, jlink.RepeatSpec) and any(map(noisy, st.stages)):
            stream, k_rep = jax.random.split(stream)
            for idx in range(st.n):
                k_i = jax.random.fold_in(k_rep, np.uint32(idx))
                for sub in st.stages:
                    if noisy(sub):
                        k_i, k_sub = jax.random.split(k_i)
                        ase.append(_normal(k_sub, (4, n)))
    out["ase"] = ase
    stream, k_pd = jax.random.split(stream)
    k_T, k_N = jax.random.split(k_pd)
    out["thermal"] = _normal(k_T, (n,))
    out["shot"] = _normal(k_N, (n,))
    return out


def jax_hdd_uniform(seed, n_sym, M):
    """The ``(n_sym, M)`` uniform draws of the JAX hard PPM receiver's
    symbol repair for link seed ``seed`` (link.py ``_ppm_hard_rx_ingraph``:
    ``fold_in(PRNGKey(seed), 0x504D)``; models/ppm.py
    ``hdd_positions_jax``), for the port's ``noise["hdd"]``."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), 0x504D)
    return np.asarray(jax.random.uniform(key, (n_sym, M), dtype=jnp.float32))


def rel_l2(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
