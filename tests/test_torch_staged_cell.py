"""The upstream OOK example through the staged drop-in API as the benchmark
runs it (``perfbench`` cell ``ook_example_50km.staged_2e24``), on the CPU
at 2^10 bits x 64: the staged entry against the benchmark's plain float64
reference (``perfbench/reference/ook_example_50km.py``) under the cell's
own limits, and the controls that must fail them; the noisy devices'
injected draws (``noise=``) against their keyed draws; the spans of a
README chain and the two readers of the cell's span metrics."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import opticomlib_tpu_torch as T
from opticomlib_tpu_torch import rng
from opticomlib_tpu_torch import devices as TD
from opticomlib_tpu_torch.models import ook
from opticomlib_tpu_torch.ops import ssfm
from opticomlib_tpu_torch.signals import OpticalSignal
from opticomlib_tpu_torch.utils import profiling
from perfbench import run
from perfbench.pbcore import cells, compare, draws

torch.set_num_threads(2)

CELL = "ook_example_50km.staged_2e24"
N_BITS, SPS = 2**10, 64
SEED = 2**32 + 2025


@pytest.fixture(autouse=True)
def _reset():
    """A fresh ``gv`` on the CPU; span recording off after each test (the
    staged entry's build turns it on)."""
    T.gv.default()
    T.gv.device = "cpu"
    yield
    profiling.record(False)
    T.gv.default()


def _cell(**link):
    c = cells.cell(CELL, dict(samples=N_BITS * SPS))
    c.cfg = copy.deepcopy(c.cfg)
    c.cfg["link"].update(link)
    return c


def _inputs(c, seed):
    """A call's pool row and unit draws, made as ``run.py`` makes them."""
    n = c.traffic["samples"]
    bits = draws.bits_pool(seed, 1, 1, n // SPS)[0]
    return bits, draws.call_draws(c.cfg, n, 1, seed, draws.CALL, 0, "cpu")


def _entry(c, bits, d):
    """The staged entry's answers on ``bits`` and ``d``, and the voltage it
    hands to the hook."""
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    vs = []
    prog.register_forward_hook(lambda _m, _i, out: vs.append(out[0]))
    return c.entry.call(prog, bits, 7, d, c.traffic)[0], vs[-1]


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_staged_entry_holds_to_the_reference(seed):
    c = _cell()
    bits, d = _inputs(c, seed)
    side, v = _entry(c, bits, d)
    ref = c.reference.run(c.cfg, c.traffic, bits[0], d[0], "cpu")
    got = compare.row(c.entry, side, v, ref)
    assert compare.judge(got, c.limits), got
    assert side["n_steps"] == ref["n_steps"] and side["n_errors"] == 0


def _noise_left_out(c, bits, d, monkeypatch):
    """The program's photodiode without its noise (``include_noise=
    'none'``)."""
    return _entry(_cell(include_thermal=False, include_shot=False), bits, d)


def _draw_shifted(c, bits, d, monkeypatch):
    """The thermal draw shifted by one sample."""
    return _entry(c, bits, [dict(d[0], thermal=torch.roll(d[0]["thermal"],
                                                          1))])


def _one_step_fewer(c, bits, d, monkeypatch):
    """The adaptive loop stopped one step short of the span's end."""
    ref = c.reference.run(c.cfg, c.traffic, bits[0], d[0], "cpu")
    monkeypatch.setattr(ssfm, "_MAX_STEPS", ref["n_steps"][0] - 1)
    return _entry(c, bits, d)


def _bfloat16(c, bits, d, monkeypatch):
    """The reference computed in bfloat16 in the program's place."""
    low = c.reference.run(c.cfg, c.traffic, bits[0], d[0], "cpu",
                          precision="bfloat16")
    return low, low["v"]


CONTROLS = {"noise_left_out": _noise_left_out,
            "draw_shifted": _draw_shifted,
            "one_step_fewer": _one_step_fewer, "bfloat16": _bfloat16}


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_controls_are_not_correct(control, monkeypatch):
    c = _cell()
    bits, d = _inputs(c, SEED + 2)
    side, v = CONTROLS[control](c, bits, d, monkeypatch)
    ref = c.reference.run(c.cfg, c.traffic, bits[0], d[0], "cpu")
    got = compare.row(c.entry, side, v, ref)
    assert not compare.judge(got, c.limits), got


# ---------------------------------------------------------------------------
# injected draws
# ---------------------------------------------------------------------------
N = 512


def _field():
    T.gv(sps=16, R=10e9, N=N // 16)
    t = torch.arange(N, dtype=torch.float64)
    return OpticalSignal(1e-3 * torch.polar(1 + 0.5 * torch.sin(t / 9),
                                            t / 50))


def _randn(seed, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=torch.float32)
            for s in shapes]


def _pd(**kw):
    return TD.PD(_field(), BW=7.5e9, include_noise="all", **kw)._total()


def _laser(**kw):
    _field()
    return TD.LASER(P0=3, lw=1e6, rin=-150, **kw).signal


def _edfa(**kw):
    return TD.EDFA(_field(), G=20, NF=5, **kw).noise


#: device -> (call, the draws a key's generator makes, in its order)
NOISY = {"PD": (_pd, {"thermal": (N,), "shot": (N,)}),
         "LASER": (_laser, {"phase": (N,), "rin": (N,)}),
         "EDFA": (_edfa, {"ase": (4, N)})}


@pytest.mark.parametrize("device", sorted(NOISY))
def test_injected_draws_equal_the_keyed_ones(device):
    fn, shapes = NOISY[device]
    keyed = fn(key=11)
    noise = dict(zip(shapes, _randn(11, *shapes.values())))
    assert torch.equal(fn(noise=noise), keyed)
    other = dict(zip(shapes, _randn(12, *shapes.values())))
    assert not torch.equal(fn(noise=other), keyed)


@pytest.mark.parametrize("device", sorted(NOISY))
def test_a_wrong_draw_raises(device):
    fn, shapes = NOISY[device]
    name, shape = next(iter(shapes.items()))
    noise = dict(zip(shapes, _randn(3, *shapes.values())))
    with pytest.raises(ValueError, match="injected draw has shape"):
        fn(noise=dict(noise, **{name: torch.zeros(shape[:-1] + (N + 1,))}))
    with pytest.raises(ValueError, match=f"no '{name}' draw"):
        fn(noise={k: v for k, v in noise.items() if k != name})
    with pytest.raises(ValueError, match="not both"):
        fn(noise=noise, key=3)


def test_injected_draws_leave_the_global_stream_alone():
    T.gv(seed=5)
    first = rng.next_key()
    T.gv(seed=5)
    _pd(noise={"thermal": torch.zeros(N), "shot": torch.zeros(N)})
    assert rng.next_key() == first
    rng.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def _readme_chain():
    T.gv(sps=64, R=10e9, wavelength=1550e-9, Vpi=5, N=N_BITS)
    np.random.seed(3)
    tx = TD.PRBS(order=15, len=T.gv.N)
    v = TD.DAC(tx, Vpp=T.gv.Vpi, offset=-T.gv.Vpi / 2,
               pulse_shape="gaussian")
    mod = TD.MZM(TD.LASER(P0=5), v, bias=-T.gv.Vpi / 2, Vpi=T.gv.Vpi,
                 loss_dB=3, ER_dB=26)
    fib = TD.FIBER(mod, length=50, alpha=0.2, beta_2=-20, gamma=2)
    pdo = TD.PD(fib, BW=T.gv.R * 0.75, r=1, include_noise="all")
    rx, eye, rth = ook.DSP(pdo)
    ber = ook.BER_analizer("counter", Tx=tx, Rx=rx)
    return dict(rx=rx.data, rth=rth, ber=ber, steps=fib.n_steps,
                **{k: getattr(eye, k) for k in ("mu0", "mu1", "s0", "s1")})


def test_readme_chain_spans():
    """Each device call is a span under the fused chain's layer names, in
    the order they close; the photodiode's LPF inside ``rx.pd`` and the
    dispersion phase inside ``fiber``; the results equal with recording
    off."""
    off = _readme_chain()
    profiling.record(True)
    on = _readme_chain()
    recs = profiling.drain()
    got = [(r["name"], r["attrs"]) for r in recs]
    assert got == [
        ("tx", {"device": "DAC"}), ("tx", {"device": "LASER"}),
        ("tx", {"device": "MZM"}), ("fiber.prepare", {}),
        ("fiber", {"kind": "staged", "method": "reference",
                   "steps": off["steps"], "fused": False}),
        ("rx.pd", {"device": "LPF"}), ("rx.pd", {"device": "PD"}),
        ("rx.eye", {"graph": "eager"}),
        ("rx.decide", {"step": "threshold"}),
        ("rx.decide", {"step": "sampler"}),
        ("rx.decide", {"step": "slicer"}), ("rx.decide", {"step": "ber"})]
    by = {r["name"] + str(r["attrs"].get("device", "")): r for r in recs}
    assert by["fiber.prepare"]["parent"] == by["fiber"]["id"]
    assert by["rx.pdLPF"]["parent"] == by["rx.pdPD"]["id"]
    assert all(r["parent"] is None for r in recs
               if r["name"] not in ("fiber.prepare",)
               and r is not by["rx.pdLPF"])
    assert all(r["t0_ns"] <= r["t1_ns"] for r in recs)
    for k, v in off.items():
        assert np.array_equal(on[k], v), k


def _fused_dsp():
    c = cells.cell("ook_50km.dsp_2e24", dict(samples=2**14))
    prog = run.build_program(c, c.traffic, torch.device("cpu"))[0]
    bits, d = _inputs(c, SEED)
    return lambda: prog.dsp(bits=bits[0], seed=3, nslots=8192, noise=d[0])


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_spans_off_record_nothing_and_read_no_clock(path, monkeypatch):
    fn = _readme_chain if path == "staged" else _fused_dsp()

    def clock():
        raise AssertionError("a span read the clock")
    profiling.record(False)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=clock))
    fn()
    assert profiling.drain() == []


def _reader(name):
    return cells.load_module(cells.HERE / "metrics" / (name + ".py"),
                             "metric").read


def _rec(name, t0, t1, **attrs):
    return dict(name=name, id=None, parent=None, call=None, t0_ns=t0,
                t1_ns=t1, attrs=attrs)


def test_span_readers_count_the_idle_time_inside_their_spans():
    """Two calls on a hand-made trace: call 1's ``fiber`` span 0-100 holds
    ``fiber.prepare`` 10-60 and the device is busy 20-30 and 80-120, so 70
    ns of it are idle; its ``rx.pd`` 200-300 and ``rx.eye`` 300-400 are
    idle but for 250-350 (100 idle), and the gap 120-200 outside every
    span is not counted.  Call 2: ``fiber`` 1000-1100, busy 1000-1100 (0
    idle), ``rx.decide`` 1100-1150 idle (50)."""
    calls = [[{"spans": [_rec("tx", 0, 0), _rec("fiber.prepare", 10, 60),
                         _rec("fiber", 0, 100), _rec("rx.pd", 200, 300),
                         _rec("rx.eye", 300, 400),
                         _rec("call.staged", 0, 400)]}],
             [{"spans": [_rec("fiber", 1000, 1100),
                         _rec("rx.decide", 1100, 1150)]}]]
    events = [(20, 30, "k"), (80, 120, "k"), (250, 350, "k"),
              (1000, 1040, "k"), (1030, 1100, "k")]
    ctx = SimpleNamespace(busy_s=1e-7, calls=calls, events=events)
    fiber = _reader("staged.fiber_idle_ms_per_call")
    rx = _reader("staged.rx_idle_ms_per_call")
    assert fiber(ctx) == pytest.approx((70 + 0) / 2 / 1e6)
    assert rx(ctx) == pytest.approx((100 + 50) / 2 / 1e6)
    # no device trace (the CPU), or a call that recorded no spans (a
    # program without them): nothing to read
    for bad in (dict(busy_s=None), dict(calls=calls + [[{}]]),
                dict(calls=[])):
        c = SimpleNamespace(**dict(vars(ctx), **bad))
        assert fiber(c) is None and rx(c) is None


@pytest.mark.parametrize("n, beta_2, beta_3", [(2**14, -20.0, 0.0),
                                               (2**14 + 1, -21.0, 0.1),
                                               (1000, 20.0, -0.05)])
def test_fiber_constants_on_the_device_equal_the_hosts(n, beta_2, beta_3):
    """``FIBER`` makes its frequency axis and dispersion phase on the
    field's device: the same bits as ``OpticalSignal.w()`` and the NumPy
    ``dispersion_phase``, signs of zero included."""
    T.gv(sps=16, R=10e9, N=64, device="cpu")
    A = torch.zeros(n, dtype=torch.complex64)
    w_host, w = OpticalSignal(A).w(), TD._w_on(A)
    assert w.dtype == torch.float64
    assert np.array_equal(w.numpy().view(np.uint64), w_host.view(np.uint64))
    phi = ssfm.dispersion_phase(w, beta_2, beta_3)
    assert isinstance(phi, torch.Tensor) and phi.dtype == torch.float32
    assert np.array_equal(
        phi.numpy().view(np.uint32),
        ssfm.dispersion_phase(w_host, beta_2, beta_3).view(np.uint32))


def test_staged_fiber_equals_the_host_constants_path():
    """The staged ``FIBER`` equals ``ssfm_propagate`` given the host's
    frequency axis, bit for bit, in the same number of steps."""
    T.gv(sps=SPS, R=10e9, Vpi=5, N=2**8, device="cpu")
    v = TD.DAC(np.arange(2**8) % 3 == 0, Vpp=5, offset=-2.5)
    E = TD.MZM(TD.LASER(P0=5), v, bias=-2.5, Vpi=5, loss_dB=3, ER_dB=26)
    fib = TD.FIBER(E, length=50, alpha=0.2, beta_2=-20, gamma=2)
    A, steps = ssfm.ssfm_propagate(E._total(), E.w(), 50.0, alpha=0.2,
                                   beta_2=-20.0, gamma=2.0)
    assert fib.n_steps == steps > 1
    assert torch.equal(fib.signal, A)


def test_the_low_pass_keeps_its_response_on_the_device():
    """``LPF`` applies the float64 Bessel response it copied once for the
    design and length: the same output as a fresh copy, and a second call
    copies nothing."""
    from opticomlib_tpu_torch.ops import filters
    x = torch.randn(4096, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    H2 = filters.bessel_filtfilt_response(4, 7.5e9, 640e9, 4096)
    want = filters.apply_freq_response(
        x, torch.as_tensor(H2.astype(np.float64)))
    filters._device_response.cache_clear()
    assert torch.equal(filters.bessel_lpf(x, 7.5e9, 640e9), want)
    assert torch.equal(filters.bessel_lpf(x, 7.5e9, 640e9), want)
    info = filters._device_response.cache_info()
    assert (info.misses, info.hits) == (1, 1)
