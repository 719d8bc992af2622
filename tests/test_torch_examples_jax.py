"""The noiseless twins of examples/torch/ held to the output of their JAX
scripts, both run here on the CPU at the same time, each in a subprocess
with a time limit of its own (tests/test_torch_examples.py has the
helpers).  Tolerances, per printed figure:

* text printed from host arithmetic only, or rounded to 3 decimals (the
  generalized MZM's Dirichlet curves, the raised-cosine eye): equal as text;
* round-off residues against theory (the MZM sweeps, ~1e-15 in both): at
  most 1e-12 in both packages;
* split-step errors against the fine-step oracle: the FFT-pair counts
  equal; an error of 1e-3 and more (truncation) within 5 % of the JAX one;
  one below (both at the float32 floor of the oracle, ~2e-4) below 1e-3 in
  both and within a factor 2; the self-tuning round trip below 1e-4 in
  both.
"""
import re

from test_torch_examples import number, run_pair


def _lines(out, start):
    return [ln.strip() for ln in out.splitlines() if ln.startswith(start)]


def test_mzm_transfer_function():
    port, jax = run_pair("mzm_transfer_function")
    for out in (port, jax):
        assert number(out, r"theory\| = (\S+)") <= 1e-12
    assert _lines(port, "extinction") == _lines(jax, "extinction") != []


def test_generalized_mzm():
    port, jax = run_pair("generalized_mzm", "--show")
    for out in (port, jax):
        assert number(out, r"ideal ER\): max \|dP\| = (\S+)") <= 1e-12
    for start in ("N=2 vs cos", "N= 4", "N=10"):
        assert _lines(port, start) == _lines(jax, start) != []


def test_rcos_pulse_eye():
    port, jax = run_pair("rcos_pulse_eye", "--show")
    assert port.strip().splitlines() == jax.strip().splitlines()


def _schemes(out):
    """{scheme label: (FFT pairs, relative error)} of the table."""
    rows = {}
    for ln in out.splitlines():
        m = re.match(r"(\S.*?h=L/\d+|\S.*?tol=\S+)\s+(\d+|\(self\))\s+(\S+)$",
                     ln.strip())
        if m:
            rows[m.group(1)] = (m.group(2), float(m.group(3)))
    return rows


def test_higher_order_ssfm():
    port, jax = run_pair("higher_order_ssfm")
    got, want = _schemes(port), _schemes(jax)
    assert set(got) == set(want) and len(want) == 8, (got, want)
    for label, (pairs, err) in want.items():
        assert got[label][0] == pairs, label
        if err >= 1e-3:
            assert abs(got[label][1] - err) <= 0.05 * err, (label, got, want)
        else:
            assert got[label][1] < 1e-3, label
            assert err / 2 <= got[label][1] <= 2 * err, (label, got, want)
    for out in (port, jax):
        assert number(out, r"round trip: (\S+)") < 1e-4
