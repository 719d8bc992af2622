"""The port's example scripts (examples/torch/), twins of examples/*.py:
every JAX example has its twin, a twin asks for the card unless given
``--device cpu`` (and raises without one), and a CPU smoke run of the
quick set, each twin in a subprocess with a time limit of its own.

A figure that does not depend on the noise generator (noiseless, or drawn
from the JAX script's own seeded ``np.random``) is held to what the JAX
script prints, run here at the same time (:func:`run_pair`).  Where the
twin draws keyed noise, torch's generator is not threefry, and the figure
is held to a stated range.  The noiseless split-step and MZM twins are in
tests/test_torch_examples_jax.py, the longer twins in
tests/test_torch_examples_more.py, the distributed ones in
tests/test_torch_examples_dist.py.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TWINS = os.path.join(EXAMPLES, "torch")
TIME_LIMIT = 240  # seconds a script may take


def _env(**env_vars):
    env = dict(os.environ, MPLBACKEND="Agg", **env_vars)
    env.pop("XLA_FLAGS", None)
    return env


def _twin_cmd(name, args, device):
    flags = ["--device", device] if device else []
    return [sys.executable, os.path.join(TWINS, name + ".py"), *flags, *args]


def _jax_cmd(name):
    return [sys.executable, os.path.join(EXAMPLES, name + ".py")]


def _checked(name, r):
    assert r.returncode == 0, f"{name}:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def run_twin(name, *args, device="cpu", check=True, **env_vars):
    """Run the twin ``name`` in a subprocess on ``device`` (``None``: no
    ``--device`` flag) with ``env_vars`` added to its environment; returns
    its output after asserting exit code 0 (``check``), or the completed
    process."""
    r = subprocess.run(_twin_cmd(name, args, device),
                       env=_env(OMP_NUM_THREADS="2", **env_vars),
                       capture_output=True, text=True, timeout=TIME_LIMIT)
    return _checked(name, r) if check else r


def run_pair(name, *args):
    """The twin ``name`` (on the CPU, with ``args``) and its JAX script,
    run at once, each in a subprocess with the time limit; their outputs
    ``(port, jax)`` after asserting that both exit 0."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in ((_twin_cmd(name, args, "cpu"),
                               _env(OMP_NUM_THREADS="2")),
                              (_jax_cmd(name), _env(JAX_PLATFORMS="cpu")))]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIME_LIMIT)
            outs.append(_checked(name, subprocess.CompletedProcess(
                p.args, p.returncode, out, err)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tuple(outs)


def number(out, pattern):
    """The float that ``pattern``'s first group matches in ``out``."""
    m = re.search(pattern, out)
    assert m, (pattern, out)
    return float(m.group(1))


def _scripts(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".py"))


# ---------------------------------------------------------------------------
# the twins exist and ask for the card
# ---------------------------------------------------------------------------
def test_every_jax_example_has_its_twin():
    jax_examples = _scripts(EXAMPLES)
    assert len(jax_examples) == 15
    assert _scripts(TWINS) == jax_examples


@pytest.mark.parametrize("name", _scripts(TWINS))
def test_twin_defaults_to_the_card(name):
    """Each twin takes ``--device`` with the card as its default."""
    tree = ast.parse(open(os.path.join(TWINS, name)).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "add_argument"
             and n.args and getattr(n.args[0], "value", "") == "--device"]
    assert len(calls) == 1, name
    default = {k.arg: k.value.value for k in calls[0].keywords
               if k.arg == "default"}
    assert default == {"default": "cuda"}, name


@pytest.mark.parametrize("name", ["mzm_transfer_function",
                                  "sharded_wdm_sweep"])
def test_twin_without_card_or_flag_raises(name):
    """Without a card (none is visible to the process) and without
    ``--device cpu`` a twin stops with the port's no-card error; it never
    carries on on the CPU."""
    r = run_twin(name, device=None, check=False, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr, r.stderr
    assert r.stdout.strip() == ""


# ---------------------------------------------------------------------------
# CPU smoke runs of the quick set, figures in stated ranges
# ---------------------------------------------------------------------------
def test_fused_link():
    """JAX script (CPU): BER 0, ook.DSP threshold 0.059, ER 10.8 dB.  The
    port's keyed noise differs from threefry, so: BER <= 1e-3 both ways,
    threshold within 10 % of 0.059, ER within 1 dB of 10.8."""
    out = run_twin("fused_link")
    assert "n = 524288 samples in one program" in out
    assert number(out, r"eye-threshold decision\): (\S+)") <= 1e-3
    assert abs(number(out, r"threshold = (\S+),") - 0.059) <= 0.1 * 0.059
    assert abs(number(out, r"ER = (\S+) dB") - 10.8) <= 1.0
    assert number(out, r"BER via ook stack: (\S+)") <= 1e-3
    assert "reproducibility: OK" in out


def test_ook_transmission_fiber_simulation():
    """Both scripts run here.  The received power is noiseless up to the
    photodiode: equal to the JAX script's to 0.01 dB, its printed step.
    The receiver's noise is unseeded in both: at most 1 error of 1024 bits
    (JAX: 0), the threshold within 10 % of 4.42e-3 and mu1 within 2 % of
    7.69e-3 (the JAX script's, CPU)."""
    out, jax = run_pair("ook_transmission_fiber_simulation")
    power = r"Average received power: (\S+) dBm"
    assert abs(number(out, power) - number(jax, power)) <= 0.01 + 1e-9
    assert number(out, r"\((\d+) errors of 1024") <= 1
    assert abs(number(out, r"threshold :\s+(\S+)") - 4.4218e-3) <= 4.4218e-4
    assert abs(number(out, r"mu1\s+:\s+(\S+)") - 7.6934e-3) <= 1.6e-4
    assert number(out, r"BER theoretical: (\S+)") <= 1e-9


def test_ppm_vs_ook_psd():
    """Noiseless: the -20 dB bandwidths (x Rb) equal to the JAX script's
    to 0.01, their printed step."""
    out, jax = run_pair("ppm_vs_ook_psd")
    for name in ("PPM M=4", "PPM M=8", "PPM M=16", "PPM M=32", "OOK"):
        pattern = re.escape(name) + r"\s+(\S+) x Rb"
        got, want = number(out, pattern), number(jax, pattern)
        assert abs(got - want) <= 0.01 + 1e-9, (name, got, want)


def test_noise_filtering_comparison():
    """The noise is drawn on the host from the JAX script's seeded
    generator, so the figures are held to the JAX run's: the three powers
    (dBm) to 0.01 dB and the NEB ratio to 0.001, their printed steps."""
    out, jax = run_pair("noise_filtering_comparison", "--show")
    for pattern, step in ((r"brick-wall output power:\s+(\S+) dBm", 0.01),
                          (r"\(prediction\s+(\S+) dBm\)", 0.01),
                          (r"Bessel output power:\s+(\S+) dBm", 0.01),
                          (r"NEB ratio (\S+)\)", 0.001)):
        got, want = number(out, pattern), number(jax, pattern)
        assert abs(got - want) <= step + 1e-9, (pattern, got, want)
