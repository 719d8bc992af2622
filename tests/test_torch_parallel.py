"""The port's sharded fiber (opticomlib_tpu_torch.parallel) on real
``torch.distributed`` CPU ranks (gloo, spawned processes), against the port
on one process and against the JAX package's ``ssfm_sharded`` on a 4-device
CPU mesh.

One launch a world size, with all its cases inside
(tests/_torch_dist_child.py), behind a module-scoped fixture: 4 ranks as a
(1, 4) mesh, 4 ranks as a (2, 2) mesh, and 2 ranks for the kill-and-resume
with a divergent crash point.  Rendezvous goes through a file under pytest's
temporary directory; every child has a time limit and is killed after it.

Tolerances.  Against the port on one process (checked inside the ranks):
those of tests/test_parallel.py, 2e-4 (linear), 5e-4 (nonlinear, WDM,
adaptive pencil) and 5e-3 (overlap) of the peak, 1e-4 relative L2 for the
higher-order schemes, with equal step counts on the pencil path.  Against
the JAX package's sharded solver on the same inputs (checked here): 1e-4 of
the peak on either path (two float32 implementations of the same transform;
on the overlap path the same halo, so the same truncation; the largest seen
is 1.5e-5); the step counts of the adaptive and self-tuning schemes equal
the JAX loops'.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_child as child
from opticomlib_tpu.ops import ssfm as jssfm
from opticomlib_tpu.parallel import dfft as jdfft
from opticomlib_tpu.parallel import fiber as jfiber
from opticomlib_tpu.parallel import halo as jhalo
from opticomlib_tpu_torch import parallel as tparallel
from opticomlib_tpu_torch.parallel import dfft as tdfft
from opticomlib_tpu_torch.parallel import fiber as tfiber
from opticomlib_tpu_torch.parallel import halo as thalo
from opticomlib_tpu_torch.parallel import multihost as tmultihost

torch.set_num_threads(2)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_dist_child.py")
TIME_LIMIT = 300  # seconds a launch may take before its children are killed


def _run_ranks(world, out_dir, suite, child=CHILD, start=0):
    """Spawn ``world`` ranks of ``suite`` of the rank script ``child``,
    from its item ``start`` on; returns (exit codes, outputs)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    rendezvous = os.path.join(out_dir, f"rendezvous_{suite}_from{start}")
    procs = [subprocess.Popen(
        [sys.executable, child, str(r), str(world), rendezvous, out_dir,
         suite, str(start)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=TIME_LIMIT)
            except subprocess.TimeoutExpired:
                # the run is over its limit: kill every rank and keep what
                # each printed, so the failure says where they stood
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out = f"(killed after {TIME_LIMIT} s)\n{out}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], outs


def _suite(tmp_path_factory, suite, prepare=None, world=4, child=CHILD):
    """Run every item of ``suite`` on ``world`` ranks of ``child``: one
    launch, and after an item that failed on some rank (the ranks stop
    there, tests/_torch_dist_items.py) a fresh launch from the item after
    it, so that no item runs in a process group that a failure has left
    unsound.  Returns the output directory, each rank's results merged over
    the launches, and the first item of each launch."""
    out_dir = str(tmp_path_factory.mktemp(suite))
    if prepare is not None:
        prepare(out_dir)
    results, launches, start = [{} for _ in range(world)], [], 0
    while True:
        codes, outs = _run_ranks(world, out_dir, suite, child, start)
        launches.append(start)
        assert codes == [0] * world, (f"launch from item {start}", outs)
        stops = set()
        for r in range(world):
            with open(os.path.join(out_dir, f"results_rank{r}.json")) as f:
                res = json.load(f)
            if "_stopped_after" in res:
                stops.add(res.pop("_stopped_after"))
            results[r].update(res)
        if not stops:
            return dict(out=out_dir, results=results, launches=launches)
        # a rank that reported late may have gone on alone past the item
        # where the others stopped: what it did there runs again
        start = min(stops) + 1


def _first_failures(run):
    """For each rank, the first item that failed there, with its
    traceback."""
    lines = []
    for r, res in enumerate(run["results"]):
        bad = [k for k, v in res.items() if not v["ok"]]
        lines.append(f"rank {r}: " + (f"first failed {bad[0]!r}\n"
                                      f"{res[bad[0]]['msg']}" if bad
                                      else "no item failed"))
    return "\n".join(lines)


def _all_ranks_ok(run, name):
    """The results of item ``name``, which every rank must have passed; the
    failure names, for each rank, the first item that failed there."""
    missing = [r for r, res in enumerate(run["results"]) if name not in res]
    failed = [r for r, res in enumerate(run["results"])
              if name in res and not res[name]["ok"]]
    assert not missing and not failed, (
        f"{name}: never reached on ranks {missing}, failed on ranks "
        f"{failed}; launches from items {run['launches']}\n"
        + _first_failures(run))
    return run["results"][0][name]


CONVERT_FIELD = child.white(4096, 7, 1.0)


def _write_jax_blocks(out_dir):
    """The JAX package's per-process checkpoint payload of a field sharded
    over 4 devices, for the ranks to take over."""
    mesh = jfiber.make_link_mesh(n_wdm=1, n_time=4, devices=jax.devices()[:4])
    blocks, indices = jfiber._host_shard_blocks(
        jfiber.shard_waveform(CONVERT_FIELD, mesh))
    np.savez(os.path.join(out_dir, "jax_blocks.npz"), re=blocks.real,
             im=blocks.imag, indices=json.dumps(indices),
             shape=np.asarray(CONVERT_FIELD.shape), whole=CONVERT_FIELD)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _suite(tmp_path_factory, "w4", _write_jax_blocks)


@pytest.fixture(scope="module")
def w2x2(tmp_path_factory):
    return _suite(tmp_path_factory, "w2x2")


def _case(request, name):
    return request.getfixturevalue(child.FIELD_CASES[name][0])


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_sharded(name):
    suite, spec, kw = child.FIELD_CASES[name]
    A = child.make_input(spec)
    shape = (1, 4) if suite == "w4" else (2, 2)
    mesh = jfiber.make_link_mesh(*shape, devices=jax.devices()[:4])
    return np.asarray(jfiber.ssfm_sharded(A, mesh, fs=child.FS, **kw))


def _jax_steps(name):
    """Step count of the JAX loop that the sharded scheme of ``name`` runs
    (``ssfm_sharded`` itself returns none), or None for a fixed schedule."""
    _, spec, kw = child.FIELD_CASES[name]
    if kw.get("h") is not None:
        return None
    A = child.make_input(spec)
    re, im = jnp.asarray(A.real), jnp.asarray(A.imag)
    w = 2 * np.pi * np.fft.fftfreq(A.shape[-1]) * child.FS
    phi_w = jssfm.dispersion_phase(w, kw["beta_2"], 0.0)
    a_km = jssfm.alpha_per_km(kw["alpha"])
    scheme = kw.get("scheme", "reference")
    if scheme == "reference":
        h0 = jssfm.adaptive_h0(kw["phi_max"], kw["gamma"], float(np.max(
            A.real**2 + A.imag**2)), kw["length"])
        return int(jssfm._ssfm_loop(re, im, phi_w, kw["length"], kw["gamma"],
                                    kw["phi_max"], h0, a_km,
                                    adaptive=True)[2])
    loop = (jssfm._ssfm_o4_auto_loop if scheme == "o4"
            else jssfm._ssfm_local_error_loop)
    return int(loop(re, im, phi_w, jnp.float32(kw["length"]),
                    jnp.float32(kw["gamma"]), jnp.float32(kw["tol"]),
                    jnp.float32(kw["length"] / 10.0), jnp.float32(a_km))[2])


# ---------------------------------------------------------------------------
# the sharded solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(child.FIELD_CASES))
def test_sharded_matches_single_process_port(request, name):
    """Inside the ranks: the gathered field against the port on one
    process, and (pencil path) the same step count."""
    res = _all_ranks_ok(_case(request, name), name)
    assert res["n_steps"] > 0


@pytest.mark.parametrize("name", list(child.FIELD_CASES))
def test_sharded_matches_jax_sharded(request, name):
    run = _case(request, name)
    res = _all_ranks_ok(run, name)
    got = np.load(os.path.join(run["out"], name + ".npy"))
    want = _jax_sharded(name)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= 1e-4, err
    steps = _jax_steps(name)
    if steps is not None:
        assert res["n_steps"] == steps


@pytest.mark.parametrize("name", list(child.CHECKS_W4))
def test_four_ranks(w4, name):
    _all_ranks_ok(w4, name)


@pytest.mark.parametrize("name", list(child.CHECKS_W2X2))
def test_two_by_two_ranks(w2x2, name):
    _all_ranks_ok(w2x2, name)


def test_fiber_mesh_drop_in_matches_jax(w4):
    """FIBER(mesh=) on 4 ranks against the JAX FIBER on the same input."""
    from opticomlib_tpu import gv
    from opticomlib_tpu.devices import FIBER
    from opticomlib_tpu.signals import OpticalSignal

    _all_ranks_ok(w4, "fiber_mesh_drop_in")
    got = np.load(os.path.join(w4["out"], "fiber_mesh_drop_in.npy"))
    gv.default()
    gv(sps=16, R=10e9, N=2**10)
    want = FIBER(OpticalSignal(child.make_input(child.FIBER_INPUT)),
                 **child.FIBER_KW).to_numpy()
    gv.default()
    assert np.max(np.abs(got - want)) <= 5e-4 * np.max(np.abs(want))


def test_fiber_mesh_then_pd_matches_jax(w4):
    """PD(FIBER(x, mesh=)) on 4 ranks against the JAX staged call on a
    4-device CPU mesh, where the photodiode takes the fiber's global
    array."""
    from opticomlib_tpu import gv
    from opticomlib_tpu.devices import FIBER, PD
    from opticomlib_tpu.signals import OpticalSignal

    _all_ranks_ok(w4, "fiber_mesh_then_pd")
    got = np.load(os.path.join(w4["out"], "fiber_mesh_then_pd.npy"))
    mesh = jfiber.make_link_mesh(n_wdm=1, n_time=4, devices=jax.devices()[:4])
    gv.default()
    gv(sps=16, R=10e9, N=2**10)
    want = PD(FIBER(OpticalSignal(child.make_input(child.FIBER_INPUT)),
                    mesh=mesh, **child.FIBER_KW), **child.PD_KW).to_numpy()
    gv.default()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 5e-4 * np.max(np.abs(want))


def test_sharded_state_crosses_to_jax(w4):
    """``convert.sharded_to_jax`` on the ranks gives what the JAX package
    rebuilds a global array from (the way there, ``sharded_from_jax`` on its
    payload, ran inside the ranks)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    _all_ranks_ok(w4, "convert_from_jax")
    d = np.load(os.path.join(w4["out"], "port_blocks.npz"))
    mesh = jfiber.make_link_mesh(n_wdm=1, n_time=4, devices=jax.devices()[:4])
    back = jfiber._assemble_from_host_shards(
        d["re"], d["im"], json.loads(str(d["indices"])),
        CONVERT_FIELD.shape, NamedSharding(mesh, P("time")))
    np.testing.assert_array_equal(np.asarray(back), CONVERT_FIELD)


def test_failed_item_fails_alone(tmp_path_factory):
    """An item that fails on one rank between two collectives leaves the
    process group a collective off; the ranks stop after it and the items
    after it run in a fresh launch, where they pass.  (In one launch the
    rank that raised would make the next item's all-gather with the others'
    pending one, and every later item would fail.)  The failure of the item
    names each rank's first failed item."""
    run = _suite(tmp_path_factory, "isolate", world=2)
    assert run["launches"] == [0, 2]
    for name in ("before", "after", "after_again"):
        _all_ranks_ok(run, name)
    res = [r["diverges"] for r in run["results"]]
    assert "simulated fault on rank 1" in res[1]["msg"]
    assert not res[0]["ok"]          # its all-gather timed out
    with pytest.raises(AssertionError) as e:
        _all_ranks_ok(run, "diverges")
    msg = str(e.value)
    assert "failed on ranks [0, 1]" in msg
    assert "rank 1: first failed 'diverges'" in msg
    assert "simulated fault on rank 1" in msg


def test_two_process_kill_and_resume_bitexact(tmp_path):
    """Two ranks die mid-run at DIFFERENT steps; a fresh pair resumes from
    the step both hold and ends bit-equal to an uninterrupted run."""
    out = str(tmp_path)
    codes, outs = _run_ranks(2, out, "crash")
    assert codes == [17, 17], outs
    files = sorted(f for f in os.listdir(os.path.join(out, "ck"))
                   if f.endswith(".npz"))
    assert files == ["ckpt_00000001.shard0.npz", "ckpt_00000001.shard1.npz",
                     "ckpt_00000002.shard1.npz"], files
    codes, outs = _run_ranks(2, out, "resume")
    assert codes == [0, 0], outs
    assert all("OK bitexact" in o for o in outs), outs


# ---------------------------------------------------------------------------
# host arithmetic, equal to the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args,kw", [
    ((0.1, -20.0, 0.0, 640e9), {}), ((0.2, -20.0, 0.0, 640e9), {}),
    ((0.1, 0.0, 0.0, 640e9), {}), ((1.0, -21.0, 0.13, 160e9), {}),
    ((5.0, -21.0, 0.0, 640e9), dict(safety=16.0)),
    ((0.5, 4.0, -0.5, 80e9), dict(safety=1.0, minimum=2))])
def test_halo_width_equals_jax(args, kw):
    assert thalo.halo_width(*args, **kw) == jhalo.halo_width(*args, **kw)
    assert thalo.halo_width(0.1, 0.0, 0.0, 640e9) == 8  # floor


def test_pad_block_operator_equals_jax():
    a = thalo.pad_block_operator(512, 24, 160e9, 0.2, -21.0, 0.1)
    b = jhalo.pad_block_operator(512, 24, 160e9, 0.2, -21.0, 0.1)
    assert a.dtype == b.dtype == np.complex64 and a.shape == (560,)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [0, 3])
def test_strided_grids_equal_jax(q):
    """The bins, the angular frequencies and the dispersion phase of a
    rank's strided spectrum slice, bit for bit: float32 in the JAX
    functions' operations and order (the phase as the JAX sharded solvers
    evaluate it, ``beta_2/2*w**2 + beta_3/6*w**3`` in rad/ps)."""
    P_, B, fs = 4, 256, 160e9
    np.testing.assert_array_equal(tdfft.strided_k_local(q, P_, B),
                                  np.asarray(jdfft.strided_k_local(q, P_, B)))
    w = tdfft.strided_w_grid(q, P_, B, fs)
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jdfft.strided_w_grid(q, P_, B, fs)))
    for b2, b3 in ((-21.0, 0.0), (-21.0, 0.13), (21.0, -0.13)):
        wj = jdfft.strided_w_grid(q, P_, B, fs) * 1e-12
        want = (b2 / 2 * wj**2 + b3 / 6 * wj**3).astype(jnp.float32)
        np.testing.assert_array_equal(
            tdfft.strided_dispersion_phase(q, P_, B, fs, b2, b3).numpy(),
            np.asarray(want))


def test_resolve_shard_method_rules(monkeypatch):
    """The rules of tests/test_parallel.py, and the JAX function's answer
    at every point."""
    fs = 640e9
    n_odd, n, n_small = 8 * 4100, 2**22, 2**14
    points = [(2**22, 8, None, dict(adaptive=True)), (2**22, 8, 0.5, {}),
              (n_odd, 8, 0.01, {}), (n, 8, 0.5, {}), (n_small, 8, 5.0, {}),
              (n_odd, 8, None, dict(adaptive=True))]

    def both(frac):
        monkeypatch.setattr(tfiber, "AUTO_HALO_FRAC", frac)
        monkeypatch.setattr(jfiber, "AUTO_HALO_FRAC", frac)
        out = []
        for nn, p, h, kw in points:
            got = tfiber.resolve_shard_method(nn, p, h, -21.0, 0.0, fs, **kw)
            assert got == jfiber.resolve_shard_method(nn, p, h, -21.0, 0.0,
                                                      fs, **kw)
            out.append(got)
        return out

    assert both(0.0) == ["pencil", "pencil", "overlap", "pencil", "pencil",
                         "overlap"]
    assert both(0.25) == ["pencil", "overlap", "overlap", "overlap",
                          "pencil", "overlap"]


def test_auto_halo_frac_reads_the_same_environment_variable():
    code = ("import os; os.environ['OPTICOMLIB_TPU_AUTO_HALO_FRAC'] = '0.125'"
            "\nfrom opticomlib_tpu_torch.parallel import fiber\n"
            "print(fiber.AUTO_HALO_FRAC)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "0.125", out.stderr
    assert tfiber.AUTO_HALO_FRAC == jfiber.AUTO_HALO_FRAC == 0.0


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------
def test_multihost_initialize_idempotent(monkeypatch):
    """An initialised runtime is not initialised again; an uninitialised
    one is, exactly once, with gloo for the CPU."""
    calls = []

    def fake_init(backend, **kw):
        calls.append((backend, kw))
        raise RuntimeError("no such coordinator")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    assert tmultihost.initialize_multihost() == 4 and calls == []

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no such coordinator"):
        tmultihost.initialize_multihost("h:1", 2, 0, device="cpu",
                                        timeout_s=60)
    assert len(calls) == 1
    backend, kw = calls[0]
    assert backend == "gloo" and kw["init_method"] == "tcp://h:1"
    assert kw["world_size"] == 2 and kw["rank"] == 0
    assert kw["timeout"].total_seconds() == 60


def test_multihost_group_destroyed_at_exit(tmp_path):
    """The process group that initialize_multihost brings up is destroyed
    when the interpreter exits, before its teardown (an exit handler
    registered before the bring-up runs after it and finds no group)."""
    code = (
        "import atexit, sys\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(CHILD))!r})\n"
        "import torch.distributed as dist\n"
        "atexit.register(lambda: print('left up:', dist.is_initialized()))\n"
        "from opticomlib_tpu_torch.parallel import initialize_multihost\n"
        f"initialize_multihost('file://{tmp_path}/r', 1, 0, device='cpu')\n"
        "print('up:', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["up:", "True", "left", "up:", "False"], (
        out.stdout, out.stderr)


def test_multihost_without_card_raises(monkeypatch):
    """No device named means the card; without one the bring-up raises and
    does not start gloo instead."""
    from opticomlib_tpu_torch import gv
    gv.default()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: 1 / 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmultihost.initialize_multihost("h:1", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmultihost.initialize_multihost("h:1", 1, 0, device="cuda")


def test_make_link_mesh_needs_the_runtime():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        tparallel.make_link_mesh(1, 1)


def test_public_names():
    from opticomlib_tpu import parallel as jparallel
    from opticomlib_tpu.parallel import multihost as jmultihost
    not_ported = set()
    assert set(tparallel.__all__) == set(jparallel.__all__) - not_ported
    for t, j in ((tfiber, jfiber), (tdfft, jdfft), (thalo, jhalo),
                 (tmultihost, jmultihost)):
        assert set(t.__all__) == set(j.__all__)
        assert all(hasattr(t, k) for k in t.__all__)
