"""Eye-diagram result container (copied from ``opticomlib_tpu.eyediag``).
Plotting and the eye-density renderer are not ported yet."""
from __future__ import annotations

from typing import Optional

__all__ = ["Eye", "eye"]


class Eye:
    """Eye-diagram parameters and metrics.

    Attributes (same names/meanings as the reference): ``t``, ``y`` traces,
    ``t_left/t_right/t_opt`` crossing times, ``mu0/mu1/s0/s1`` level stats,
    ``er`` extinction ratio [dB], ``eye_h`` eye opening, ``threshold``
    optimal decision threshold, ``i`` optimum sampling instant, ``sps``.
    """

    def __init__(self, params: Optional[dict] = None, **kwargs):
        params = dict(params or {})
        params.update(kwargs)
        self.__dict__.update(params)
        self.execution_time = params.get("execution_time", 0.0)

    def __getattr__(self, name):
        # undefined metrology fields read as None (reference tolerates
        # partially-filled eye dicts, e.g. tests/ook_test.py MockEye)
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __str__(self, title: Optional[str] = None):
        title = title or "eye diagram parameters"
        head = 3 * "*" + f"    {title}    " + 3 * "*"
        sub = len(head) * "-"

        def fmt(v):
            if v is None:
                return "None"
            if isinstance(v, float):
                return f"{v:.4e}"
            return str(v)

        fields = ["t_left", "t_right", "t_opt", "t_dist", "mu0", "mu1",
                  "s0", "s1", "er", "eye_h", "threshold", "i", "sps"]
        body = "\n".join(f"\t{k:10s}:  {fmt(getattr(self, k))}"
                         for k in fields)
        return f"\n{sub}\n{head}\n{sub}\n{body}\n"

    def print(self, msg: Optional[str] = None):
        if msg:
            print(msg)
        print(self)
        return self

    @property
    def empty(self) -> bool:
        """True when the object carries no trace data."""
        return self.__dict__.get("y") is None


# reference-compatible lowercase alias
eye = Eye
