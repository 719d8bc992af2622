"""The port's lab layer (``opticomlib_tpu_torch.lab``), case for case as
tests/test_lab.py checks the JAX package's: the post-processing (SYNC,
GET_EYE_v2, HDF5 I/O) with its oracles and held to the JAX functions on the
same inputs, and the SCPI drivers in debug mode (``addr=None`` prints
commands instead of sending them), the port's printed commands equal to the
JAX drivers'.  Host NumPy in both: results are held equal.
"""
import numpy as np
import pytest
import torch

from opticomlib_tpu import gv as jgv, lab as jlab, signals as js
from opticomlib_tpu_torch import BinarySequence, ElectricalSignal, gv, lab

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset():
    gv.default()
    gv.device = "cpu"
    yield
    gv.default()
    jgv.default()


def _gv(**kw):
    gv(device="cpu", **kw)
    jgv(**kw)


def _printed(capsys, make, calls):
    """The commands printed by ``calls(driver)`` on the port's driver and on
    the JAX one (``make(module)`` builds it); asserts they are equal."""
    out = []
    for mod in (lab, jlab):
        drv = make(mod)
        capsys.readouterr()
        calls(drv)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    return out[0]


# ------------------------------------------------------------------- SYNC
def test_SYNC_finds_offset():
    _gv(sps=8, R=1e9)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 256)
    tx = np.repeat(bits, 8).astype(float)
    delay = 37
    rx = np.concatenate([rng.normal(0.5, 0.05, delay), tx,
                         rng.normal(0.5, 0.05, 500)])
    rx += rng.normal(0, 0.02, rx.size)
    out, i = lab.SYNC(rx, bits, sps=8)
    jout, ji = jlab.SYNC(rx, bits, sps=8)
    assert i == ji == delay
    sig = out.signal.numpy().real
    np.testing.assert_array_equal(sig, np.asarray(jout.signal).real)
    assert sig.size == rx.size - tx.size
    m = min(sig.size, tx.size)
    np.testing.assert_allclose(sig[:m], tx[:m], atol=0.12)
    # a signal input: the synced signal stays on its device
    out2, i2 = lab.SYNC(ElectricalSignal(torch.as_tensor(rx)),
                        BinarySequence(bits))
    assert i2 == delay and out2.device.type == "cpu"
    np.testing.assert_array_equal(out2.signal.numpy(), sig)


def test_SYNC_validation():
    for mod in (lab, jlab):
        with pytest.raises(ValueError):
            mod.SYNC(np.zeros(100), np.ones(4))  # sps missing
        with pytest.raises(TypeError):
            mod.SYNC("nope", np.ones(4), sps=2)
        with pytest.raises(TypeError):
            mod.SYNC(np.zeros(100), [1, 0], sps=2)
        with pytest.raises(BufferError):
            mod.SYNC(np.zeros(10), np.ones(100), sps=4)
        with pytest.raises(ValueError):
            rng = np.random.default_rng(0)
            bits = rng.integers(0, 2, 64)
            mod.SYNC(rng.normal(0, 1, 1000), bits, sps=4)


# ------------------------------------------------------------- GET_EYE_v2
def test_GET_EYE_v2_known_bits():
    _gv(sps=16, R=1e9)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 512)
    y = np.repeat(bits.astype(float), 16)
    y = y + rng.normal(0, 0.03, y.size)
    noise = rng.normal(0, 0.01, y.size)
    eye = lab.GET_EYE_v2(ElectricalSignal(y, noise), BinarySequence(bits),
                         nslots=512)
    jeye = jlab.GET_EYE_v2(js.ElectricalSignal(y, noise),
                           js.BinarySequence(bits), nslots=512)
    for k in ("mu0", "mu1", "s0", "s1", "threshold", "er", "eye_h", "i",
              "t_opt", "t_dist", "sps", "dt"):
        np.testing.assert_equal(getattr(eye, k), getattr(jeye, k), k)
    for k in ("y", "t", "ones", "zeros", "t0", "t1"):
        np.testing.assert_array_equal(getattr(eye, k), getattr(jeye, k))
    assert abs(eye.mu1 - 1.0) < 0.02
    assert abs(eye.mu0 - 0.0) < 0.02
    assert abs(eye.s0 - 0.03) < 0.01
    assert 0.2 < eye.threshold < 0.8
    assert eye.eye_h == pytest.approx(
        eye.mu1 - 3 * eye.s1 - eye.mu0 - 3 * eye.s0)


def test_get_eye_v2_odd_nslots():
    _gv(sps=8, R=1e9)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 1200)
    y = np.repeat(bits, 8).astype(float)
    eye = lab.GET_EYE_v2(ElectricalSignal(y), BinarySequence(bits),
                         nslots=1001)
    assert eye.y.size == eye.t.size
    assert (eye.y.size // 8) % 2 == 0
    jeye = jlab.GET_EYE_v2(js.ElectricalSignal(y), js.BinarySequence(bits),
                           nslots=1001)
    assert eye.y.size == jeye.y.size and eye.mu1 == jeye.mu1


# ------------------------------------------------------------------ HDF5
def test_h5_roundtrip(tmp_path):
    f = str(tmp_path / "meas")
    t = np.linspace(0, 1e-6, 100)
    v = np.sin(2 * np.pi * 5e6 * t)
    lab.save_h5(f, time=t, voltage=v, frame=np.ones((3, 4)),
                metadata={"inst": "PPG3204", "rate": 10e9})
    back = lab.load_h5(f)
    np.testing.assert_array_equal(back["time"], t)
    np.testing.assert_array_equal(back["voltage"], v)
    assert back["metadata"]["inst"] == "PPG3204"
    assert back["metadata"]["rate"] == "10000000000.0"
    jback = jlab.load_h5(f)
    assert sorted(jback) == sorted(back)
    np.testing.assert_array_equal(jback["frame"], back["frame"])


# ---------------------------------------------------------- SCPI drivers
def test_PPG3204_debug_commands(capsys):
    def calls(ppg):
        ppg.patt_len(1000, CHs=2)
        ppg.patt_type("PRBS", CHs=1)
        ppg.prbs(15, CHs=1)
        ppg.data_rate(10e9)
        ppg.output("ON", CHs=3)
    out = _printed(capsys, lambda m: m.PPG3204(), calls)
    assert "[DEBUG] :DIG2:PATT:LENG 1000" in out
    assert "[DEBUG] :DIG1:PATT:TYPE PRBS" in out
    assert "[DEBUG] :DIG1:PATT:PLEN 15" in out
    assert "[DEBUG] :FREQ 1.00000e+10" in out
    assert "[DEBUG] :OUTP3 ON" in out


def test_PPG3204_data_chunking(capsys):
    out = _printed(capsys, lambda m: m.PPG3204(),
                   lambda p: p.data("110100", CHs=1))
    assert "[DEBUG] :DIG1:PATT:DATA 1,6,#16110100" in out
    out = _printed(capsys, lambda m: m.PPG3204(),
                   lambda p: p.data(np.ones(1500, dtype=int), CHs=1))
    assert ":DIG1:PATT:DATA 1,1024,#41024" in out
    assert ":DIG1:PATT:DATA 1025,476,#3476" in out
    # a tensor of bits is chunked the same
    assert out == _printed(capsys, lambda m: m.PPG3204(),
                           lambda p: p.data(torch.ones(1500,
                                                       dtype=torch.int64),
                                            CHs=1))


def test_PPG3204_limits_and_validation():
    ppg = lab.PPG3204()
    with pytest.raises(ValueError):
        ppg.prbs(13)
    with pytest.raises(ValueError):
        ppg.patt_type("WRONG")
    with pytest.raises(ValueError):
        ppg.data("012")
    with pytest.warns(UserWarning):
        ppg.patt_len(2**22)  # clipped to 2^21
    with pytest.warns(UserWarning):
        ppg.data_rate(50e9)  # clipped to 32 GHz
    with pytest.warns(UserWarning):
        ppg._check_channels([1, 9])


def test_PPG3204_bulk_call(capsys):
    out = _printed(capsys, lambda m: m.PPG3204(), lambda p: p(
        data_rate=20e9, patt_type="DATA", patt_len=8, data="10110010",
        amplitude=0.5, offset=-1.0, output=1, CHs=1))
    assert ":FREQ 2.00000e+10" in out
    assert ":DIG1:PATT:TYPE DATA" in out
    assert ":DIG1:PATT:DATA 1,8,#1810110010" in out
    assert ":VOLT1:POS 0.5v" in out
    assert ":VOLT1:NEG:OFFS 1.0v" in out
    assert ":OUTP1 1" in out


def test_PED4002_node_mapping_and_commands(capsys):
    def calls(ped):
        ped.patt_type("PRBS", CHs=2)   # ch2 data node = SENS3
        ped.prbs(31, CHs=2)
        ped.sync(CHs=1, wait=False)
        ped.sync_threshold(1e-3, CHs=1)
        ped.run(CHs=1)
        ped.get_ber(CHs=1)
        ped.delay(12.5, CHs=1)         # ch1 clock node = INP2
    out = _printed(capsys, lambda m: m.PED4002(), calls)
    assert ":SENS3:PATT:TYPE PRBS" in out
    assert ":SENS3:PATT:PLEN 31" in out
    assert ":SENS1:SYNC:EXEC ONCE" in out
    assert ":SENS1:SYNC:THR 1.0e-03" in out
    assert ":SENS1:GATE:STATE ON" in out
    assert ":FETC:SENS1:ERAT?" in out
    assert ":INP2:DEL 12.5ps" in out


def test_IDPhotonics_debug_commands(capsys):
    def calls(laser):
        laser.wavelength(1550.12, ch=1)
        laser.power(13.0, ch=2)
        laser.output(True, ch=1)
    out = _printed(capsys, lambda m: m.IDPhotonics(host=None), calls)
    assert "[DEBUG] WAV 1,1,1,1550.12" in out
    assert "[DEBUG] POW 1,1,2,13.0" in out
    assert "[DEBUG] State 1,1,1,1" in out
    assert "bwai 1,1,1" in out


def test_LeCroy_parse_block_and_wavedesc():
    scope = lab.LeCroy_WavExp100H()
    raw = b"C1:WF DAT1,#3008" + bytes(range(8))
    arr = scope._parse_IEEE488p2_block(raw, np.int8)
    np.testing.assert_array_equal(arr, np.arange(8, dtype=np.int8))
    desc = ("VERTICAL_GAIN        : 0.0015\n"
            "VERTICAL_OFFSET      : 0.25\n"
            "HORIZ_INTERVAL       : 2.5e-11\n"
            "WAVE_ARRAY_COUNT     : 512\n")
    assert scope._extract_value(desc, "VERTICAL_GAIN") == 0.0015
    assert scope._extract_value(desc, "WAVE_ARRAY_COUNT") == 512
    jscope = jlab.LeCroy_WavExp100H()
    np.testing.assert_array_equal(
        jscope._parse_IEEE488p2_block(raw, np.int8), arr)


def test_EXFO_debug_commands(capsys):
    def calls(att):
        att.attenuation(3.5)
        att.wavelength(1550)
        att.calibrate()
    out = _printed(capsys, lambda m: m.EXFO_FVA60B(), calls)
    assert "[DEBUG] >A-03.50<" in out
    assert "[DEBUG] >L1550<" in out
    assert "[DEBUG] >Z<" in out


def test_namespace_matches_jax():
    """The lab module's names: the JAX module's ``__all__`` and the
    reference's drop-in aliases (tests/test_round2_fixes.py)."""
    assert lab.__all__ == jlab.__all__
    assert all(hasattr(lab, k) for k in lab.__all__)
    assert isinstance(3, lab.IntegerNumber) and isinstance(3.5,
                                                           lab.RealNumber)
    assert lab.eye is lab.Eye and lab.binary_sequence is BinarySequence
