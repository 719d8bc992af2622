#!/usr/bin/env python3
"""Time the port's three full-size paths in two checkouts on one card.

    python3 scripts/compare_torch_paths.py PARENT_DIR [CHANGE_DIR]

``PARENT_DIR`` and ``CHANGE_DIR`` (default: this checkout) each hold
``chip_smoke.py`` and ``opticomlib_tpu_torch/`` (for a parent commit:
``git archive <commit> | tar -x -C build/parent``).  The paths run in one
process per checkout, in the order parent, change, change, parent, so both
versions see the same card in one call: config 2 and config 4 through
``LinkProgram.dsp`` (one first call, then steady calls) and the staged README
chain (three runs, with the wall time of each device call), all at 2^24
samples through the helpers of that checkout's ``chip_smoke.py``,
``cmul`` alone on both of its shapes, and the histogram wrappers on the
receivers' shapes (``histogram2d`` with a row-index array at (1, 4096) over
2^20 eye-like samples, (16, 4096) and (16, 8192) over 16 x 2^20, (256, 256)
over 2^22, one launch at a time and ten queued; ``histogram_rows`` too where
the checkout has it).  Each run prints one ``RESULT`` line of JSON.  Needs a
CUDA card and ``nvcc``.
"""
import json
import os
import subprocess
import sys


def one(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    import torch

    import chip_smoke as cs
    from opticomlib_tpu_torch import link
    from opticomlib_tpu_torch.ops import _build, kernels
    from opticomlib_tpu_torch.ops.prbs import prbs
    from opticomlib_tpu_torch.params import SimParams
    assert os.path.abspath(link.__file__).startswith(root), link.__file__
    _build.build()
    out = {"tag": tag, "root": root}

    def dsp_times(spec, n_bits, sps, steady):
        params = SimParams.create(sps=sps, R=cs.R, _warn=False)
        prog = link.build_link(spec, n_bits, params, device="cuda")
        bits = prbs(15, length=n_bits)[0]
        d, launches, t_first, walls, _ = cs.timed_dsp(
            torch, kernels, prog, bits, steady=steady)
        return dict(first=t_first, steady=walls, launches=launches,
                    ber=d.ber, n_steps=sum(d.n_steps))

    out["config2"] = dsp_times(cs.config2_spec(link), cs.N_BITS, cs.SPS, 6)
    out["config4"] = dsp_times(cs.config4_spec(link), cs.N_BITS4, cs.SPS4, 4)
    runs = []
    for _ in range(3):
        kernels.reset_launches()
        d = cs.staged_chain(torch, cs.N_BITS, "cuda", np_seed=1, timed=True)
        runs.append({k: d["walls"][k] for k in ("DAC", "FIBER", "PD",
                                                 "chain")})
    out["staged"] = dict(runs=runs, launches=dict(kernels.LAUNCHES),
                         ber=d["ber"])
    g = torch.Generator(device="cuda").manual_seed(0)
    A, E = (torch.randn(2**24, generator=g, device="cuda",
                        dtype=torch.complex64) for _ in range(2))
    A2 = torch.randn(2, 2**24, generator=g, device="cuda",
                     dtype=torch.complex64)
    out["cmul_ms"] = cs.cuda_ms(torch, lambda: kernels.cmul(A, E))
    out["cmul_2pol_ms"] = cs.cuda_ms(torch, lambda: kernels.cmul(A2, E))
    del A, E, A2

    def eye_like(shape, ny):
        """Bins as a receiver's KDE sees them: nine in ten masked (-1), the
        rest around two levels."""
        level = torch.where(torch.rand(shape, generator=g, device="cuda")
                            > 0.5, 0.75, 0.25)
        v = level + 0.02 * torch.randn(shape, generator=g, device="cuda")
        bins = torch.clamp((v * ny).to(torch.int32), 0, ny - 1)
        return torch.where(torch.rand(shape, generator=g, device="cuda")
                           < 0.1, bins, -1)

    def row_index(nrow, n):
        return torch.arange(nrow, device="cuda",
                            dtype=torch.int32).repeat_interleave(n)

    hist = {}
    for label, y, ny in (
            ("(1, 4096) eye-like", eye_like((1, 2**20), 4096), 4096),
            ("(16, 4096) eye-like", eye_like((16, 2**20), 4096), 4096),
            ("(16, 4096) uniform", torch.randint(
                0, 4096, (16, 2**20), generator=g, device="cuda",
                dtype=torch.int32), 4096),
            ("(16, 8192) uniform", torch.randint(
                0, 8192, (16, 2**20), generator=g, device="cuda",
                dtype=torch.int32), 8192)):
        t, flat = row_index(*y.shape), y.reshape(-1)
        want = kernels.histogram2d_ref(t, flat, y.shape[0], ny)
        fns = {"pairs": lambda: kernels.histogram2d(t, flat, y.shape[0], ny)}
        if hasattr(kernels, "histogram_rows"):
            fns["rows"] = lambda: kernels.histogram_rows(y, ny)
        for name, fn in fns.items():
            assert torch.equal(fn(), want), (label, name)
            hist[f"{name} {label}"] = (cs.cuda_ms(torch, fn),
                                       cs.cuda_ms(torch, fn, inner=10))
    t22 = torch.randint(0, 256, (2**22,), generator=g, device="cuda",
                        dtype=torch.int32)
    for label, y22 in (("eye-like", eye_like((2**22,), 256)),
                       ("uniform", torch.randint(
                           0, 256, (2**22,), generator=g, device="cuda",
                           dtype=torch.int32))):
        fn = lambda: kernels.histogram2d(t22, y22, 256, 256)
        assert torch.equal(fn(), kernels.histogram2d_ref(t22, y22, 256, 256))
        hist[f"pairs (256, 256) 2^22 {label}"] = (
            cs.cuda_ms(torch, fn), cs.cuda_ms(torch, fn, inner=10))
    out["histogram_ms_one_and_queued"] = hist
    print("RESULT " + json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        return one(sys.argv[2], sys.argv[3])
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) == 3 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root, tag in ((parent, "parent1"), (change, "change1"),
                      (change, "change2"), (parent, "parent2")):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root, tag]).returncode
        if rc:
            raise SystemExit(f"{tag} ({root}) exited with {rc}")


if __name__ == "__main__":
    main()
