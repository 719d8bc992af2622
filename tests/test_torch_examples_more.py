"""The longer single-process twins of examples/torch/ on the CPU, each in a
subprocess with a time limit of its own (tests/test_torch_examples.py has
the helpers).  Where a twin seeds legacy ``np.random`` (PPM, the long-haul
link, the laser), the port draws the JAX devices' numbers in their order:
the JAX script runs here too, at the same time, and the twin's figures are
held to what it prints, each to its printed step.  Where a twin draws keyed
noise (the dispersion-managed link), the port's generator is not threefry,
and the figures are held to stated ranges."""
from test_torch_examples import number, run_pair, run_twin


def test_ppm_transmission():
    """The error counts, hard and soft, equal to the JAX script's (0 of 384
    bits there)."""
    out, jax = run_pair("ppm_transmission")
    for decision in ("hard", "soft"):
        pattern = (decision + r"-decision BER: \S+ \((\d+) errors "
                   r"/ 384 bits\)")
        assert number(out, pattern) == number(jax, pattern), decision


def test_longhaul_dbp():
    """The power after 20 spans to 0.01 dB and the post-DBP EVM to 0.001 of
    the JAX script's (4.19 dBm and 0.103 there)."""
    out, jax = run_pair("longhaul_dbp")
    for pattern, step in ((r"after 20 spans: P = (\S+) dBm", 0.01),
                          (r"EVM vs launched field: (\S+)", 0.001)):
        got, want = number(out, pattern), number(jax, pattern)
        assert abs(got - want) <= step + 1e-9, (pattern, got, want)


def test_dispersion_managed_link():
    """JAX script: BER 0, threshold 0.0425 (keyed noise, another generator
    here: BER <= 1e-3, threshold within 5 %); the fused chain against the
    staged one 1.4e-5 of the peak (noiseless, both float32: below 1e-4)."""
    out = run_twin("dispersion_managed_link")
    assert number(out, r"BER = (\S+)") <= 1e-3
    assert abs(number(out, r"threshold = (\S+)") - 0.0425) <= 0.05 * 0.0425
    assert number(out, r"max rel err = (\S+)") < 1e-4


def test_laser_linewidth_demo():
    """The measured FWHM for 20 and 100 MHz linewidths to 0.1 MHz of the
    JAX script's (15.6 and 93.7 MHz there)."""
    out, jax = run_pair("laser_linewidth_demo")
    for lw in (20, 100):
        pattern = rf"lw =\s+{lw} MHz  ->  measured FWHM =\s+(\S+)"
        got, want = number(out, pattern), number(jax, pattern)
        assert abs(got - want) <= 0.1 + 1e-9, (lw, got, want)
