"""The 95th percentile (linear) of the host-clock wall of every call in
the window, in ms.  A call ends in host scalars, so it ends synchronised;
its wall includes making its unit noise draws."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.walls, 95)) * 1e3
