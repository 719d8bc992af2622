"""The share of the traced calls whose receiver eye metrology
(``ops/eyeana.eye_scalars``) replayed its CUDA graph, in %, from the
calls' answers (``eye_graph``, read by the entry driver from the
program's ``eyeana.GRAPH_COUNTS``); ``None`` where the answers do not say."""


def read(ctx):
    flags = [ch.get("eye_graph") for res in ctx.calls for ch in res]
    if not flags or any(f is None for f in flags):
        return None
    return 100.0 * sum(flags) / len(flags)
