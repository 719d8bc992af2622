#!/usr/bin/env python3
"""The sharded fused link against the unsharded one at world size 1, and
where their difference comes from.

    python3 scripts/compare_sharded_link.py [--device cpu|cuda] [--bits N]
    python3 scripts/compare_sharded_link.py --jax [--bits N]

One rank (gloo on the CPU, NCCL on the card), ``make_link_mesh(1, 1)``: at
one rank the pencil transform is exact, so what separates
``build_link(mesh=).jitted`` from ``LinkProgram.jitted`` is float32
round-off, chiefly the dispersion phase (the sharded program evaluates it in
float32 on the strided grid, as the JAX sharded program does; the unsharded
one rounds a float64 host phase).  For config 2 and config 4 without noise
(``N`` bits a channel: sps 64 and 16), prints the max abs difference of the
photodiode voltage over its peak, as built and with the sharded program
given the unsharded phase, and the step counts.

``--jax`` makes the same comparison inside the JAX package, on the CPU: its
``ShardedLinkProgram`` on a 1-D 'time' mesh of 1 and of 4 CPU devices
against its ``LinkProgram``, on the same noiseless config-4 input (``N``
bits, default 2^16: 2^20 samples), and prints the same max gap over the
peak, so the port's gap can be set beside the reference's own.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the configurations)
from opticomlib_tpu_torch import link  # noqa: E402
from opticomlib_tpu_torch.ops import ssfm  # noqa: E402
from opticomlib_tpu_torch.ops.prbs import prbs  # noqa: E402
from opticomlib_tpu_torch.params import SimParams  # noqa: E402
from opticomlib_tpu_torch.parallel import (initialize_multihost,  # noqa: E402
                                           make_link_mesh)


def jax_gap(n_bits: int):
    """The JAX package's sharded against unsharded link, config 4 without
    noise, at 1 and 4 CPU devices."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from opticomlib_tpu import link as jlink
    from opticomlib_tpu.ops.prbs import prbs as jprbs
    from opticomlib_tpu.params import SimParams as JSimParams

    spec = dataclasses.replace(chip_smoke.config4_spec(jlink, noisy=False),
                               include_thermal=False, include_shot=False)
    params = JSimParams.create(sps=16, R=chip_smoke.R, _warn=False)
    bits = np.asarray(jprbs(15, length=n_bits)[0].data, np.float32)
    v0 = np.asarray(jlink.build_link(spec, n_bits, params=params).jitted(
        jnp.asarray(bits), jnp.uint32(3))[0])
    for n_dev in (1, 4):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("time",))
        pr = jlink.build_link(spec, n_bits, params=params, mesh=mesh)
        v1 = np.asarray(pr.jitted(bits[None], np.uint32([3]))[0])[0]
        err = float(np.max(np.abs(v1 - v0)) / np.max(np.abs(v0)))
        print(f"JAX config 4, {n_bits * 16} samples: ShardedLinkProgram on "
              f"{n_dev} CPU device(s) vs LinkProgram {err:.3g} of the peak",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--bits", type=int, default=None)
    ap.add_argument("--jax", action="store_true",
                    help="the JAX package's own gap (CPU)")
    args = ap.parse_args()
    if args.jax:
        return jax_gap(args.bits or 2**16)
    args.bits = args.bits or 2**12
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    rendezvous = tempfile.TemporaryDirectory()
    initialize_multihost(f"file://{rendezvous.name}/r", 1, 0,
                         device=args.device)
    mesh = make_link_mesh(1, 1)
    quiet = dict(include_thermal=False, include_shot=False)
    c2 = chip_smoke.config2_spec(link)
    cases = (
        ("config 2", dataclasses.replace(
            c2, stages=(c2.stages[0], link.EDFASpec(G=10)), **quiet), 64),
        ("config 4", dataclasses.replace(
            chip_smoke.config4_spec(link, noisy=False), **quiet), 16))
    for name, spec, sps in cases:
        params = SimParams.create(sps=sps, R=chip_smoke.R, _warn=False)
        bits = prbs(15, length=args.bits)[0].astype(np.float32)
        o0 = link.build_link(spec, args.bits, params, device=dev).jitted(
            torch.as_tensor(bits, device=dev), 3)
        prog = link.build_link(spec, args.bits, params, mesh=mesh)
        o1 = prog.jitted(bits, [3])
        w = 2 * np.pi * np.fft.fftfreq(prog.n) * params.fs
        for key in prog._phi:
            prog._phi[key] = torch.as_tensor(
                ssfm.dispersion_phase(w, *key), device=prog.device)
        o2 = prog.jitted(bits, [3])
        v0 = o0[0]
        errs = [float((o[0].local[0] - v0).abs().max() / v0.abs().max())
                for o in (o1, o2)]
        print(f"{name}, {args.bits * sps} samples: sharded vs unsharded "
              f"{errs[0]:.3g} of the peak; with the unsharded phase "
              f"{errs[1]:.3g}; steps {sum(o0[2])} / "
              f"{sum(int(s[0]) for s in o1[2])}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
