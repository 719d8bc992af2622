"""Entry driver of the staged drop-in API: the README chain as its users
write it, one device call at a time on the port's signal objects,

    tx  = BinarySequence(bits)
    v   = DAC(tx, Vpp, offset, pulse_shape)
    mod = MZM(LASER(P0), v, bias, Vpi, loss_dB, ER_dB)
    fib = FIBER(mod, length, alpha, beta_2, gamma)
    pdo = PD(fib, BW, r, include_noise="all", noise=draws)
    rx, eye, rth = ook.DSP(pdo)
    ber = ook.BER_analizer("counter", Tx=tx, Rx=rx)

with the configuration's values, under ``gv(sps, R, wavelength, Vpi,
N)``.  The noisy devices whose draws the configuration uses take the
call's unit draws (``noise=``), as the fused entries' ``dsp(noise=)``
does.  Span recording is on from the build: each answer carries the spans
its call recorded (``spans``), which the ``staged.*`` metrics read against
the device trace, and whether the eye metrology replayed a CUDA graph
(``eye_graph``, from the program's ``eyeana.GRAPH_COUNTS``).  The timed
path's
voltage reaches ``run.py`` and ``set_limits.py`` through the program's
``register_forward_hook``, as a module's would."""
from types import SimpleNamespace

from perfbench.pbcore.ook import NAMES, readings, receiver_bytes  # noqa: F401
from perfbench.pbcore.ook import answer

#: ``PD``'s ``include_noise`` by the configuration's (thermal, shot)
_INCLUDE = {(True, True): "all", (True, False): "thermal-only",
            (False, True): "shot-only", (False, False): "none"}


class StagedChain:
    """The configuration's link for the staged devices (``spec``, a
    ``LinkSpec``; ``sps``) on ``device``.  ``register_forward_hook`` as a
    module's: each hook is called after the photodiode with ``(self, None,
    (v,))``, ``v`` the voltage (``_total()``: signal and noise tracks)."""

    def __init__(self, spec, sps: int, device):
        self.spec, self.sps, self.device, self.hooks = spec, sps, device, []

    def register_forward_hook(self, hook):
        self.hooks.append(hook)
        return SimpleNamespace(remove=lambda: self.hooks.remove(hook))


def build(link, spec, params, n_bits: int, traffic: dict, device):
    """``gv`` set for the chain (the JAX package's ``gv`` call of the
    example, on ``device``), span recording on."""
    from opticomlib_tpu_torch import gv
    from opticomlib_tpu_torch.utils import profiling
    gv(sps=params.sps, R=params.R, wavelength=params.wavelength,
       Vpi=spec.Vpi, N=int(n_bits), device=str(device))
    profiling.record(True)
    profiling.drain()
    return StagedChain(spec, params.sps, device)


def call(prog, bits, seed: int, draws: list, traffic: dict) -> list:
    """``bits``: ``(1, n_bits)``; ``draws``: one channel's dict (``seed``
    is not used: every draw is injected).  Returns the channel's answers
    and the spans the call recorded."""
    from opticomlib_tpu_torch.devices import DAC, FIBER, LASER, MZM, PD
    from opticomlib_tpu_torch.models import ook
    from opticomlib_tpu_torch.ops import eyeana
    from opticomlib_tpu_torch.signals import BinarySequence
    from opticomlib_tpu_torch.utils import profiling
    s, d = prog.spec, draws[0]
    laser_noise = d if s.lw is not None or s.rin is not None else None
    replayed = eyeana.GRAPH_COUNTS["replayed"]
    with profiling.span("call.staged", n=bits.shape[-1] * prog.sps):
        tx = BinarySequence(bits[0])
        v = DAC(tx, Vpp=s.Vpp, offset=s.offset, pulse_shape=s.pulse_shape,
                coupling=s.coupling, **dict(s.pulse_kwargs))
        x = MZM(LASER(P0=s.P0, lw=s.lw, rin=s.rin, df=s.df,
                      noise=laser_noise), v,
                bias=s.bias, Vpi=s.Vpi, loss_dB=s.loss_dB, ER_dB=s.ER_dB)
        steps = []
        for st in s.stages:
            if type(st).__name__ != "FiberSpec":
                raise NotImplementedError(f"stage {st!r}")
            x = FIBER(x, length=st.length, alpha=st.alpha, beta_2=st.beta_2,
                      beta_3=st.beta_3, gamma=st.gamma, phi_max=st.phi_max,
                      h=st.h, method=st.method, tol=st.tol)
            steps.append(x.n_steps)
        pdo = PD(x, BW=s.pd_BW, r=s.pd_r, T=s.pd_T, R_load=s.pd_R_load,
                 include_noise=_INCLUDE[s.include_thermal, s.include_shot],
                 i_dark=s.i_dark, Fn=s.pd_Fn, noise=d)
        for hook in prog.hooks:
            hook(prog, None, (pdo._total(),))
        rx, eye, rth = ook.DSP(pdo)
        ber = ook.BER_analizer("counter", Tx=tx, Rx=rx)
    return [dict(answer(round(ber * tx.size), rth, eye.mu0, eye.mu1, eye.s0,
                        eye.s1, steps, True), spans=profiling.drain(),
                 eye_graph=eyeana.GRAPH_COUNTS["replayed"] > replayed)]
