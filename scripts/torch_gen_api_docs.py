"""Generate the port's API reference pages (docs/torch_reference/*.md) from
the docstrings of ``opticomlib_tpu_torch``: one page for each module of the
JAX package's reference pages (scripts/gen_api_docs.py writes those to
docs/reference/), but the two the port leaves out (``runtime.cache``,
``runtime.backend``).

Usage: python scripts/torch_gen_api_docs.py      (writes docs/torch_reference/)

Deterministic output (members in ``__all__`` order, no timestamps), so the
pages are committed and a test holds them to this script's output.
"""
import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "docs", "torch_reference")

# module -> (page title, reference counterpart)
MODULES = {
    "opticomlib_tpu_torch.params": ("Simulation parameters (gv / SimParams)",
                                    "typing.py:106-388 (global_variables)"),
    "opticomlib_tpu_torch.signals": ("Signal types", "typing.py:402-2427"),
    "opticomlib_tpu_torch.devices": ("Device library", "devices.py"),
    "opticomlib_tpu_torch.link": ("Fused link programs", "no counterpart "
                                  "(new capability; staged chain: "
                                  "examples/)"),
    "opticomlib_tpu_torch.link_sharded": ("Sharded fused link",
                                          "no counterpart (new capability)"),
    "opticomlib_tpu_torch.link_pipeline": ("Pipelined fused link",
                                           "no counterpart (new "
                                           "capability)"),
    "opticomlib_tpu_torch.models.ook": ("OOK modulation stack", "ook.py"),
    "opticomlib_tpu_torch.models.ppm": ("PPM modulation stack", "ppm.py"),
    "opticomlib_tpu_torch.eyediag": ("Eye diagrams", "typing.py:2469-2809"),
    "opticomlib_tpu_torch.lab": ("Lab / instrument layer", "lab.py"),
    "opticomlib_tpu_torch.utils.analysis": ("Numeric & analysis utilities",
                                            "utils.py"),
    "opticomlib_tpu_torch.utils.theory": ("Analytic BER / noise theory",
                                          "utils.py:1288-1493"),
    "opticomlib_tpu_torch.ops.ssfm": ("SSFM propagation engine",
                                      "devices.py:1038-1206 (FIBER)"),
    "opticomlib_tpu_torch.ops.eyeana": ("Eye metrology kernels",
                                        "devices.py:1635-1868 (GET_EYE)"),
    "opticomlib_tpu_torch.ops.filters": ("Filter kernels",
                                         "devices.py:788-826, 1286-1375"),
    "opticomlib_tpu_torch.ops.pulses": ("Pulse shapes & resampling",
                                        "utils.py:1791-1981"),
    "opticomlib_tpu_torch.ops.prbs": ("PRBS generation", "devices.py:63-182"),
    "opticomlib_tpu_torch.parallel.fiber": ("Sharded SSFM runtime",
                                            "no counterpart (new "
                                            "capability)"),
    "opticomlib_tpu_torch.parallel.pipeline": ("Span pipelining",
                                               "no counterpart (new "
                                               "capability)"),
    "opticomlib_tpu_torch.parallel.dfft": ("Distributed pencil FFT",
                                           "no counterpart (new "
                                           "capability)"),
    "opticomlib_tpu_torch.parallel.multihost": ("Multi-host bring-up",
                                                "no counterpart (new "
                                                "capability)"),
    "opticomlib_tpu_torch.runtime.checkpoint": ("Checkpoint / resume",
                                                "no counterpart (new "
                                                "capability)"),
    "opticomlib_tpu_torch.logger": ("Hierarchical logging", "logger.py"),
    "opticomlib_tpu_torch.utils.profiling": ("Profiling hooks",
                                             "utils.py:268-340 (tic/toc)"),
}


def _first_para(doc):
    if not doc:
        return "*(no docstring)*"
    doc = inspect.cleandoc(doc)
    return doc.split("\n\n")[0].replace("\n", " ")


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod)
                 if not n.startswith("_")
                 and getattr(vars(mod)[n], "__module__", None)
                 == mod.__name__]
    return [(n, getattr(mod, n)) for n in names
            if getattr(mod, n, None) is not None]


def render(mod_name, title, ref):
    mod = importlib.import_module(mod_name)
    lines = [f"# {title}", "",
             f"`{mod_name}` — reference counterpart: `{ref}`.", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    members = _members(mod)
    funcs = [(n, o) for n, o in members
             if inspect.isfunction(o) or inspect.isbuiltin(o)]
    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    others = [(n, o) for n, o in members
              if (n, o) not in funcs and (n, o) not in classes]

    if classes:
        lines += ["## Classes", ""]
        for n, o in classes:
            lines += [f"### `{n}{_sig(o)}`", "", _first_para(o.__doc__),
                      ""]
            methods = sorted(
                (mn, mo) for mn, mo in vars(o).items()
                if not mn.startswith("_") and callable(mo))
            for mn, mo in methods:
                lines += [f"- **`{n}.{mn}{_sig(mo)}`** — "
                          f"{_first_para(mo.__doc__)}"]
            if methods:
                lines.append("")
    if funcs:
        lines += ["## Functions", ""]
        for n, o in funcs:
            lines += [f"### `{n}{_sig(o)}`", "", _first_para(o.__doc__),
                      ""]
    if others:
        lines += ["## Data", ""]
        for n, o in others:
            lines += [f"- **`{n}`** — `{type(o).__name__}`"]
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def page_name(mod_name: str) -> str:
    return mod_name.replace("opticomlib_tpu_torch.", "").replace(
        ".", "_") + ".md"


def pages() -> dict:
    """{file name: text} of every page and the index."""
    out = {}
    index = ["# API reference of the PyTorch port", "",
             "Generated from the docstrings of `opticomlib_tpu_torch` by "
             "`scripts/torch_gen_api_docs.py` (re-run it after changing "
             "any public docstring). The JAX package's pages are in "
             "`docs/reference/`; the port's map and differences in "
             "`docs/torch_port.md`.", ""]
    for mod_name, (title, ref) in MODULES.items():
        fn = page_name(mod_name)
        out[fn] = render(mod_name, title, ref)
        index.append(f"- [{title}]({fn}) — `{mod_name}`")
    out["index.md"] = "\n".join(index) + "\n"
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    for fn, text in pages().items():
        with open(os.path.join(OUT, fn), "w") as f:
            f.write(text)
        print(f"wrote docs/torch_reference/{fn}")


if __name__ == "__main__":
    main()
