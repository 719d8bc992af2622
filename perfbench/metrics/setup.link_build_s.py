"""Host wall of the program's ``setup.build_link`` spans (``build_link``:
the link's spectral constants made on the host and copied to the device),
in s, over the run."""


def read(ctx):
    walls = [r["t1_ns"] - r["t0_ns"] for r in getattr(ctx, "spans", None)
             or () if r["name"] == "setup.build_link"]
    return sum(walls) / 1e9 if walls else None
