"""The calibration twins (scripts/torch_calibrate_equal_accuracy.py,
torch_calibrate_dbp_o4.py, torch_ber_equal_accuracy.py) held to the JAX
scripts they port, both run here on the CPU at one small size: config 2 at
2^14 samples, config 4 at 2^12, the BER check at 2^9 bits.

Each JAX script is loaded as a module with its ``ROOT`` (and the DBP
script's ``N``) pointed at a temporary directory, so it writes only there;
each twin gets ``--device cpu --out <tmp>``.  Tolerances:

* step and FFT-pair counts of every candidate: equal;
* every relative error of 1e-3 and more: within 2 % of the JAX one (the
  printed 3 significant digits included); the truth cross-checks (~1e-3,
  the float32 floor of the run) within the same 2 %;
* config 4's round-trip residual of the matched o4 step, ~1e-4, is float32
  round-off of 40 spans through two FFT libraries: below the target in
  both and within a factor 3 of the JAX one (measured 1.5e-4 against
  7.3e-5); the parity scheme's decorrelated residual (~1.7) within 2 %;
* the matched step, tol and phi_max of every grid: equal, unless the JAX
  error of a candidate lies within the 2 % of its target (then the two
  scripts may stop one candidate apart, and the test says which);
* the BER check, whose noise is threefry in JAX and Philox here: each
  scheme's threshold and Q within 4 seed-to-seed standard deviations of the
  JAX value (the deviations of the twin at seeds 11-22, 2^9 bits, on the
  CPU, per power, in ``BER_SPREAD``), the BER zero where the JAX one is,
  and no bit decided differently by the two schemes at the four highest
  powers.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
REL = 0.02
#: the twin's seed-to-seed relative standard deviation of (Q, threshold)
#: per launch power [dBm], seeds 11-22 at 2^9 bits on the CPU
BER_SPREAD = {-9.0: (0.028, 0.030), -6.0: (0.021, 0.023),
              2.0: (0.008, 0.0085), 7.0: (0.004, 0.0044),
              12.0: (0.002, 0.0019), 16.0: (0.002, 0.0015)}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_calibration_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name: str, root, argv, **globals_) -> tuple:
    """The JAX script ``name`` writing under ``root``: its JSON and
    stdout."""
    mod = _load(name)
    mod.ROOT = str(root)
    for k, v in globals_.items():
        setattr(mod, k, v)
    out, argv0 = io.StringIO(), sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv0
    with open(os.path.join(root, "EQUAL_ACCURACY.json")) as f:
        return json.load(f), out.getvalue()


def _run_twin(name: str, path, argv) -> tuple:
    """The twin ``name`` on the CPU, merging into ``path``: its JSON and
    stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(name).main(["--device", "cpu", "--out", str(path), *argv])
    with open(path) as f:
        return json.load(f), out.getvalue()


def _candidates(out: str) -> dict:
    """{(grid, key=value): (FFT pairs, printed error)} of config 2's
    output, the reference scheme's steps under ``("reference", ...)``."""
    rows = {}
    for m in re.finditer(r"\[calibrate\] (.+?) (\w+=\S+): (\d+) FFT-pairs, "
                         r"\S+ s, rel err (\S+)", out):
        rows[(m.group(1), m.group(2))] = (int(m.group(3)),
                                          float(m.group(4)))
    m = re.search(r"reference scheme \(phi_max=0.01\): (\d+) steps, \S+ s, "
                  r"rel err (\S+)", out)
    rows[("reference", "phi_max=0.01")] = (int(m.group(1)),
                                           float(m.group(2)))
    return rows


def _close(a: float, b: float, rel: float = REL) -> bool:
    return abs(a - b) <= max(rel * abs(b), 1e-5)


@pytest.fixture(scope="module")
def config2(tmp_path_factory):
    jdir, tdir = (tmp_path_factory.mktemp(s) for s in ("jax2", "twin2"))
    jax_json, jax_out = _run_jax("calibrate_equal_accuracy", jdir,
                                 ["--n", "14"])
    twin_json, twin_out = _run_twin("torch_calibrate_equal_accuracy",
                                    tdir / "EQ.json", ["--n", "14"])
    return dict(jax=jax_json, twin=twin_json, jax_out=jax_out,
                twin_out=twin_out, jdir=jdir, tdir=tdir)


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    jdir, tdir = (tmp_path_factory.mktemp(s) for s in ("jax4", "twin4"))
    jax_json, jax_out = _run_jax("calibrate_dbp_o4", jdir, [], N=2**12)
    twin_json, twin_out = _run_twin("torch_calibrate_dbp_o4",
                                    tdir / "EQ.json", ["--n", "12"])
    return dict(jax=jax_json["config4"], twin=twin_json["config4"],
                jax_out=jax_out, twin_out=twin_out)


@pytest.fixture(scope="module")
def ber(config2, tmp_path_factory):
    """The BER check after config 2's calibration of each package, which
    gives the matched o4 step it reads."""
    jdir, tdir = (tmp_path_factory.mktemp(s) for s in ("jaxber", "twinber"))
    shutil.copy(config2["jdir"] / "EQUAL_ACCURACY.json", jdir)
    shutil.copy(config2["tdir"] / "EQ.json", tdir)
    jax_json, _ = _run_jax("ber_equal_accuracy", jdir, ["--bits", "9"])
    twin_json, _ = _run_twin("torch_ber_equal_accuracy", tdir / "EQ.json",
                             ["--bits", "9"])
    return dict(jax=jax_json["ber_check"], twin=twin_json["ber_check"])


def test_config2_candidates_equal_in_steps_and_error(config2):
    jax, twin = (_candidates(config2[k]) for k in ("jax_out", "twin_out"))
    assert set(twin) == set(jax) and len(jax) > 10
    for key, (pairs, e) in jax.items():
        assert twin[key][0] == pairs, (key, twin[key], pairs)
        assert _close(twin[key][1], e), (key, twin[key][1], e)


def test_config2_entries_match_jax(config2):
    jax, twin = config2["jax"], config2["twin"]
    assert twin["config"] == jax["config"]
    assert twin["reference_scheme"]["n_steps"] == \
        jax["reference_scheme"]["n_steps"]
    assert _close(twin["reference_scheme"]["error"],
                  jax["reference_scheme"]["error"])
    assert _close(twin["truth"]["cross_check_rel_err"],
                  jax["truth"]["cross_check_rel_err"])
    assert {k: v for k, v in twin["truth"].items()
            if k != "cross_check_rel_err"} == {
        k: v for k, v in jax["truth"].items() if k != "cross_check_rel_err"}
    cands = _candidates(config2["jax_out"])
    ref_error = jax["reference_scheme"]["error"]
    for path, key, target in ((("o4",), "h", ref_error),
                              (("local_error",), "tol", ref_error),
                              (("tight", "reference_scheme"), "phi_max",
                               jax["tight"]["target_error"]),
                              (("tight", "o4"), "h",
                               jax["tight"]["target_error"])):
        j, t = jax, twin
        for p in path:
            j, t = j[p], t[p]
        if (j is None) != (t is None) or (j and j[key] != t[key]):
            near = [c for c, (_, e) in cands.items()
                    if c[1].startswith(key) and abs(e - target)
                    <= REL * target]
            pytest.fail(f"{'.'.join(path)}: JAX {j}, twin {t}; JAX "
                        f"candidates within 2 % of the target {target:.4g}: "
                        f"{near}")
        if j is not None:
            assert t["fft_pairs"] == j["fft_pairs"]
            assert _close(t["error"], j["error"])
    assert twin["device"]["name"] == "cpu"
    assert "synchronize" in twin["note"]


def test_config4_matches_jax(config4):
    jax, twin = config4["jax"], config4["twin"]
    assert {k: jax[k] for k in ("metric", "rt_target")} == \
        {k: twin[k] for k in ("metric", "rt_target")}
    assert twin["parity"]["fft_pairs"] == jax["parity"]["fft_pairs"]
    assert twin["parity"]["phi_max"] == jax["parity"]["phi_max"]
    assert _close(twin["parity"]["rt_error"], jax["parity"]["rt_error"])
    assert jax["o4"] is not None and twin["o4"] is not None
    assert twin["o4"]["h"] == jax["o4"]["h"]
    assert twin["o4"]["fft_pairs"] == jax["o4"]["fft_pairs"]
    assert _close(twin["o4"]["fwd_error"], jax["o4"]["fwd_error"])
    rt_t, rt_j = twin["o4"]["rt_error"], jax["o4"]["rt_error"]
    assert max(rt_t, rt_j) <= jax["rt_target"]
    assert rt_j / 3 <= rt_t <= 3 * rt_j, (rt_t, rt_j)
    # every candidate tried: the same counts and forward errors
    pat = (r"o4 h=(\S+): (\d+) fft-pairs, rt err \S+, fwd err vs "
           r"local_error truth ([-+.e\d]+)")
    jc, tc = (re.findall(pat, config4[k]) for k in ("jax_out", "twin_out"))
    assert [c[:2] for c in tc] == [c[:2] for c in jc] != []
    for a, b in zip(tc, jc):
        assert _close(float(a[2]), float(b[2])), (a, b)
    assert twin["n_samples"] == 2**12


def test_ber_check_matches_jax_statistically(ber):
    jax, twin = ber["jax"], ber["twin"]
    for k in ("n_bits", "sps", "seed", "o4_h", "reference_phi_max",
              "method"):
        assert twin[k] == jax[k], k
    assert [r["P0_dBm"] for r in twin["rows"]] == \
        [r["P0_dBm"] for r in jax["rows"]] == sorted(BER_SPREAD)
    for rj, rt in zip(jax["rows"], twin["rows"]):
        sd_q, sd_th = BER_SPREAD[rj["P0_dBm"]]
        for scheme in ("reference", "o4"):
            j, t = rj[scheme], rt[scheme]
            assert abs(t["q"] / j["q"] - 1) <= 4 * sd_q, (rj["P0_dBm"],
                                                          scheme, t, j)
            assert abs(t["threshold"] / j["threshold"] - 1) <= 4 * sd_th, (
                rj["P0_dBm"], scheme, t, j)
            if j["n_errors"] == 0:
                assert t["n_errors"] == 0, (rj["P0_dBm"], scheme, t)
        assert rt["ber_ci_2sigma"] == rj["ber_ci_2sigma"] or \
            rt["reference"]["ber"] != rj["reference"]["ber"]
    assert [r["bit_disagreements"] for r in twin["rows"][-4:]] == [0] * 4


def test_ber_schemes_draw_the_same_noise(monkeypatch):
    """The link draws every noise from one generator in stage order and the
    fiber draws nothing, whatever its scheme: with one seed the reference
    and the o4 link get the same EDFA and PD draws."""
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.params import SimParams
    ber_twin = _load("torch_ber_equal_accuracy")
    orig = link.gaussian
    seen = []

    def recording(shape, sigma, generator, draw=None):
        if draw is None:
            draw = torch.randn(shape, generator=generator,
                               device=generator.device, dtype=torch.float32)
        seen[-1].append(draw.clone())
        return orig(shape, sigma, generator, draw)

    monkeypatch.setattr(link, "gaussian", recording)
    params = SimParams.create(sps=16, R=ber_twin.R, _warn=False)
    bits = np.random.default_rng(0).integers(0, 2, 256).astype(np.uint8)
    steps = []
    for method in ("reference", "o4"):
        seen.append([])
        prog = link.build_link(ber_twin.spec_for(16.0, method, 2.0), 256,
                               params=params, device="cpu")
        steps.append(prog.run(bits=bits, seed=ber_twin.SEED).n_steps)
    assert steps[0] != steps[1]  # two schemes, two step counts
    # the EDFA's (4, n) ASE draw, then the PD's thermal and shot draws
    assert [tuple(d.shape) for d in seen[0]] == [(4, 4096), (4096,),
                                                (4096,)]
    assert len(seen[1]) == len(seen[0])
    for a, b in zip(*seen):
        assert torch.equal(a, b)


def test_twins_never_write_the_jax_record(tmp_path):
    """``--out EQUAL_ACCURACY.json`` (the JAX package's record at the
    repository root) is refused, and no card means no default device."""
    common = _load("torch_calibration_common")
    with pytest.raises(SystemExit):
        common.parse_args(["--device", "cpu", "--out",
                           os.path.join(ROOT, "EQUAL_ACCURACY.json")],
                          "doc", {})
    assert common.DEFAULT_OUT == os.path.join(ROOT,
                                              "EQUAL_ACCURACY_CUDA.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.parse_args(["--out", str(tmp_path / "x.json")], "doc", {})
