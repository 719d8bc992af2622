"""Device-to-host copies (each ``.item()``, ``.tolist()`` and ``.cpu()``
of a device tensor, the adaptive fiber's per-step read-back among them)
over the traced calls."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return ctx.dtoh / ctx.n_calls
