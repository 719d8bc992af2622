"""The port's API reference pages (docs/torch_reference/) are what
scripts/torch_gen_api_docs.py generates from the docstrings, and they cover
the modules of the JAX package's pages (scripts/gen_api_docs.py) but the
two the port leaves out."""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = os.path.join(ROOT, "docs", "torch_reference")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_docs_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generated():
    return _load("torch_gen_api_docs").pages()


def test_pages_cover_the_jax_reference_but_what_is_not_ported():
    jax_modules = set(_load("gen_api_docs").MODULES)
    port = {m.replace("opticomlib_tpu_torch", "opticomlib_tpu", 1)
            for m in _load("torch_gen_api_docs").MODULES}
    assert jax_modules - port == {"opticomlib_tpu.runtime.cache",
                                  "opticomlib_tpu.runtime.backend"}
    assert port <= jax_modules


def test_committed_pages_equal_the_generator(generated):
    assert sorted(os.listdir(PAGES)) == sorted(generated)
    for name, text in generated.items():
        with open(os.path.join(PAGES, name)) as f:
            assert f.read() == text, (
                f"docs/torch_reference/{name} is stale: run python "
                "scripts/torch_gen_api_docs.py")


def test_pages_name_the_port_and_its_aliases(generated):
    assert "`sdd_positions_jax(" in generated["models_ppm.md"]
    assert "`eye_metrics_jit(" in generated["ops_eyeana.md"]
    for name, text in generated.items():
        assert "opticomlib_tpu_torch" in text, name
    assert generated["index.md"].count("](") == len(generated) - 1
