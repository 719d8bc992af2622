"""The ``torch.distributed`` twins of examples/torch/ alone, at world size
1 over gloo (``--device cpu``), each in a subprocess with a time limit of
its own (tests/test_torch_examples.py has the helpers).  The JAX scripts
run on 8 virtual devices, so their meshes are larger than one rank's; the
figures that do not depend on the mesh are held to what they print, the
noisy ones to stated ranges."""
import ast

import numpy as np

from test_torch_examples import number, run_pair, run_twin


def test_sharded_fused_link():
    """JAX script: BER 0 on 4 channels, thresholds 0.0623-0.0626, the
    time-sharded channel BER 0 at 10.8 dB ER.  Keyed noise from another
    generator: BERs <= 1e-3, thresholds within 5 % of 0.0625, ER within
    1 dB."""
    out = run_twin("sharded_fused_link")
    assert "mesh: {'wdm': 1, 'time': 1}" in out
    ber = ast.literal_eval(out.split("per-channel BER:")[1].splitlines()[0]
                           .strip().replace(". ", ".0,").replace(".]", ".0]"))
    assert len(ber) == 4 and max(ber) <= 1e-3
    th = np.array(out.split("per-channel threshold:")[1].splitlines()[0]
                  .strip(" []").split(), float)
    assert th.shape == (4,) and np.all(np.abs(th - 0.0625) <= 0.05 * 0.0625)
    assert number(out, r"single channel: BER=(\S+)") <= 1e-3
    assert abs(number(out, r"ER=(\S+) dB") - 10.8) <= 1.0


def test_sharded_wdm_sweep():
    """Noiseless: one channel at world size 1, against the single-process
    engine to 1e-5 of the peak (JAX: 4.6e-6 on 8 devices); its power is the
    JAX script's channel 0, from the JAX run here, to 5e-5 relative (40
    float32 nonlinear steps, one rank's FFT against an 8-device pencil FFT;
    1.1e-5 seen)."""
    out, jax = run_pair("sharded_wdm_sweep")
    assert "devices: 1 -> mesh ('wdm'=1, 'time'=1)" in out
    assert number(out, r"relative error: (\S+)") <= 1e-5
    p, want = (ast.literal_eval(o.split("powers per channel [W]:")[1].strip())
               for o in (out, jax))
    assert len(p) == 1 and len(want) == 2
    assert abs(p[0] - want[0]) <= 5e-5 * want[0], (p, want)


def test_span_pipeline_link():
    """Noiseless spans: a transparent link keeps the launch power, 5.205 mW,
    and both powers equal the JAX run's as printed.  The pipelined link's
    channels (keyed noise) all at BER <= 1e-3."""
    out, jax = run_pair("span_pipeline_link")
    assert "1-span x 80 km link, 8 microbatches of 4096 samples" in out
    assert "mean output power:    5.205 mW (transparent link, input " \
           "5.205 mW)" in out
    for pattern in (r"mean output power:\s+(\S+) mW",
                    r"\(transparent link, input (\S+) mW\)"):
        assert number(out, pattern) == number(jax, pattern), pattern
    ber = ast.literal_eval(out.split("BER = ")[1].strip())
    assert len(ber) == 2 and max(ber) <= 1e-3
