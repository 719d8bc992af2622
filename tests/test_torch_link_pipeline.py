"""The port's span pipeline (opticomlib_tpu_torch.parallel.pipeline) and
pipelined link (link_pipeline.PipelinedLinkProgram, ``build_link(span_mesh=)``)
on real ``torch.distributed`` CPU ranks (gloo, spawned processes), against
the port's sequential chains inside the ranks and against the JAX package's
pipeline on a 4-device CPU mesh here.

One launch a world size, with all its cases inside
(tests/_torch_link_pipeline_child.py), behind a module-scoped fixture: 4
ranks as a ``('span',)`` mesh and one rank (S = 1).  Each case is its own
test below.

Tolerances, those of the JAX tests (tests/test_parallel.py,
tests/test_link_pipeline.py).  Inside the ranks: ``span_pipeline`` within
5e-4 of the peak of the spans applied one after another (1e-3 for the
sharded-output case), ``span_pipeline_stages`` within 2e-5 of the fused
link's field; the pipelined link's sweeps against the fused link's: BER
equal, thresholds rtol 1e-4 and ``mu1`` rtol 1e-4 (config 4; the stage
matrix 1e-3), the hard PPM threshold rtol 1e-3.  Against the JAX package
(checked here): ``_stage_segments``' columns and ``|H|^2`` bank bit for bit;
``span_pipeline_stages`` and ``span_pipeline`` within 2e-5 of the peak of the
JAX results on the same input and the JAX ASE draws (``gaussian_inside`` of
the ``fold_in`` keys), and without ASE; the pipelined ``dsp_wdm(8)`` on the
JAX program's TX constants and every JAX draw: error counts equal,
thresholds and ``mu1`` rtol 1e-4.  The keyed-ASE chain at 1 rank and at 4 is
bit-equal.
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import _torch_link_pipeline_child as child
from _torch_parity import jax_draws
from opticomlib_tpu import link as jlink
from opticomlib_tpu import params as jparams
from opticomlib_tpu.parallel import pipeline as jpipe
from opticomlib_tpu_torch import link as tlink
from opticomlib_tpu_torch.parallel import pipeline as tpipe
from test_torch_parallel import _run_ranks

torch.set_num_threads(2)

CHILD = os.path.join(os.path.dirname(__file__),
                     "_torch_link_pipeline_child.py")
SEED_LINK = 11


def _jax_mesh():
    return jpipe.make_span_mesh(4, devices=jax.devices()[:4])


def _jparams():
    return child.params_of(jparams)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jax.numpy.float32))


def _keyed(seed, m, s, shape):
    """The JAX pipeline's unit draws of microbatch ``m`` in segment (span)
    ``s``: ``fold_in(fold_in(PRNGKey(seed), m), s)``."""
    key = jax.random.PRNGKey(np.uint32(seed))
    return _normal(jax.random.fold_in(jax.random.fold_in(key, m), s), shape)


def _link_bits():
    return np.random.default_rng(12).integers(
        0, 2, (8, child.N_BITS)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_link():
    spec = child.make_spec(jlink, child.NOISY8, **child.JAX_LINK)
    return jlink.build_link(spec, child.N_BITS, params=_jparams(),
                            span_mesh=_jax_mesh())


def _write_jax_inputs(out_dir):
    """The JAX side's inputs and draws for the ``jax_inputs`` case."""
    B, n = child.CHAIN_B, child.CHAIN_N
    d = {"chain_in": child.batch(B, n, 5)}
    d["chain_ase"] = np.stack([np.stack([_keyed(0, m, s, (4, n))
                                         for s in range(8)])
                               for m in range(B)])
    d["spans_ase"] = np.stack([np.stack([_keyed(0, m, s, (2, n))
                                         for s in range(4)])
                               for m in range(B)])
    pr = _jax_link()
    n_link = pr.n
    tx_spec = dataclasses.replace(pr.spec, stages=(), include_thermal=False,
                                  include_shot=False)
    draws = {k: [] for k in ("phase", "rin", "thermal", "shot", "ase")}
    for c in range(8):
        tx = jax_draws(SEED_LINK + c, n_link, tx_spec)
        draws["phase"].append(tx["phase"])
        draws["rin"].append(tx["rin"])
        k_pd = jax.random.fold_in(
            jax.random.PRNGKey(np.uint32(SEED_LINK + c)), 0x5044)
        k_T, k_N = jax.random.split(k_pd)
        draws["thermal"].append(_normal(k_T, (n_link,)))
        draws["shot"].append(_normal(k_N, (n_link,)))
        draws["ase"].append(np.stack([_keyed(SEED_LINK, c, s, (4, n_link))
                                      for s in range(8)]))
    d.update({f"link_{k}": np.stack(v) for k, v in draws.items()})
    d["link_bits"] = _link_bits()
    d.update({f"const_{k}": np.asarray(v) for k, v in pr.consts.items()})
    np.savez(os.path.join(out_dir, "jax_inputs.npz"), **d)


def _suite(tmp_path_factory, suite, world, prepare=None):
    out_dir = str(tmp_path_factory.mktemp(suite))
    if prepare is not None:
        prepare(out_dir)
    codes, outs = _run_ranks(world, out_dir, suite, child=CHILD)
    assert codes == [0] * world, outs
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"results_rank{r}.json")) as f:
            results.append(json.load(f))
    return dict(out=out_dir, results=results)


@pytest.fixture(scope="module")
def s4(tmp_path_factory):
    return _suite(tmp_path_factory, "s4", 4, _write_jax_inputs)


@pytest.fixture(scope="module")
def s1(tmp_path_factory):
    return _suite(tmp_path_factory, "s1", 1)


def _all_ranks_ok(run, name):
    for r, res in enumerate(run["results"]):
        assert name in res, f"rank {r} never reached {name}"
        assert res[name]["ok"], f"rank {r}: {res[name]['msg']}"
    return run["results"][0][name]


# ---------------------------------------------------------------------------
# inside the ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(set(child.CHECKS_S4) - {"jax_inputs"}))
def test_four_span_ranks(s4, name):
    _all_ranks_ok(s4, name)


@pytest.mark.parametrize("name", sorted(child.MATRIX))
def test_pipelined_stage_matrix(s4, name):
    """Every stage type through the pipelined link against the fused link
    (tests/test_link_pipeline.py's matrix)."""
    _all_ranks_ok(s4, f"matrix_{name}")


@pytest.mark.parametrize("name", sorted(child.CHECKS_S1))
def test_one_span_rank(s1, name):
    _all_ranks_ok(s1, name)


def test_keyed_ase_one_rank_equals_four(s1, s4):
    """The ASE is keyed by (microbatch, segment), not by the schedule: the
    sequential run (1 rank) and the 4-rank pipeline are bit-equal."""
    _all_ranks_ok(s1, "stages_keyed_ase_schedule")
    _all_ranks_ok(s4, "stages_keyed_ase_schedule")
    one = np.load(os.path.join(s1["out"], "ase_chain_1.npy"))
    four = np.load(os.path.join(s4["out"], "ase_chain_4.npy"))
    assert one.shape == (child.CHAIN_B, 2, child.CHAIN_N)
    np.testing.assert_array_equal(four, one)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _port_outputs(s4):
    _all_ranks_ok(s4, "jax_inputs")
    return np.load(os.path.join(s4["out"], "port_outputs.npz"))


def _peak_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name,ase", [("chain_ase", True),
                                      ("chain_quiet", False)])
def test_span_pipeline_stages_matches_jax(s4, name, ase):
    stages = child.ASE_CHAIN if ase else child.QUIET_CHAIN
    want = np.asarray(jpipe.span_pipeline_stages(
        child.batch(child.CHAIN_B, child.CHAIN_N, 5), _jax_mesh(),
        child.CHAIN_FS, child.make_stages(jlink, stages), seed=0))
    got = _port_outputs(s4)[name]
    assert got.shape == want.shape == ((child.CHAIN_B, 2, child.CHAIN_N)
                                       if ase else
                                       (child.CHAIN_B, child.CHAIN_N))
    assert _peak_err(got, want) <= 2e-5


def test_span_pipeline_matches_jax_with_ase(s4):
    want = np.asarray(jpipe.span_pipeline(
        child.batch(child.CHAIN_B, child.CHAIN_N, 5), _jax_mesh(),
        child.CHAIN_FS, 5.0, alpha=0.2, beta_2=-21.0, gamma=1.3, h=0.5,
        NF=5.0, seed=0))
    assert _peak_err(_port_outputs(s4)["spans_ase"], want) <= 2e-5


def test_pipelined_dsp_wdm_matches_jax(s4):
    """The JAX program's TX constants (loaded through convert) and all its
    draws: the same error counts, thresholds and mu1 within 1e-4."""
    got = _port_outputs(s4)
    want = _jax_link().dsp_wdm(8, bits=_link_bits(), seed=SEED_LINK)
    np.testing.assert_array_equal(got["link_n_errors"], want.n_errors)
    np.testing.assert_allclose(got["link_threshold"], want.threshold,
                               rtol=1e-4)
    np.testing.assert_allclose(got["link_mu1"], want.mu1, rtol=1e-4)


_SEGMENT_CASES = dict(child.MATRIX, noisy8=child.NOISY8,
                      ase_chain=child.ASE_CHAIN, dm_attenuator=(
                          ("fiber", dict(length=40, alpha=0.2, beta_2=-21.0,
                                         gamma=0.0)),
                          ("dm", dict(D=21.0 * 40)), ("edfa", dict(G=-3.0)),
                          ("edfa", dict(G=2.0, NF=4.0, BW=1e10)),
                          ("bpf", dict(BW=2e10, n=2))))


@pytest.mark.parametrize("name", sorted(_SEGMENT_CASES))
def test_stage_segments_bit_equal_jax(name):
    """The host lowering: every parameter column, the ASE flag and the
    |H|^2 bank equal the JAX function's bit for bit."""
    stages = _SEGMENT_CASES[name]
    fs, n = child.SPS * child.R, 2048
    got = tpipe._stage_segments(child.make_stages(tlink, stages), fs, None, n)
    want = jpipe._stage_segments(child.make_stages(jlink, stages), fs, None,
                                 n)
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        assert got[0][k].dtype == np.float64
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    assert got[1] == want[1]
    assert got[2].dtype == np.float32 and got[2].shape == want[2].shape
    np.testing.assert_array_equal(got[2], want[2])


def test_flatten_stage_specs_equals_jax():
    stages = child.MATRIX["dbp_undo"] + child.MATRIX["dm"]
    got = tpipe._flatten_stage_specs(child.make_stages(tlink, stages))
    want = jpipe._flatten_stage_specs(child.make_stages(jlink, stages))
    assert [type(s).__name__ for s in got] == [type(s).__name__
                                               for s in want]
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s)
                                                    for s in want]


def test_pipeline_segments_reject_negative_gain_ase():
    """An EDFASpec with NF set and G < 0 dB fails at build time, alone or
    merged into a fiber segment, as in the JAX package."""
    with pytest.raises(ValueError, match="G >= 0"):
        tpipe._stage_segments((tlink.EDFASpec(G=-3.0, NF=5.0),), fs=1e11,
                              f0=None, n=64)
    with pytest.raises(ValueError, match="G >= 0"):
        tpipe._stage_segments((tlink.FiberSpec(length=10, h=1.0),
                               tlink.EDFASpec(G=-3.0, NF=5.0)), fs=1e11,
                              f0=None, n=64)


def test_make_span_mesh_needs_the_runtime():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        tpipe.make_span_mesh(1)
