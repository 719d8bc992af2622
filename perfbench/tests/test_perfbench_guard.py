"""The run refuses without a card and fails when JAX or the JAX package
was loaded; the top-level names are compared whole."""
import sys
import types

from perfbench import run


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen",
                 "opticomlib_tpu", "opticomlib_tpu.link"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib",
                                       "opticomlib_tpu"]


def test_the_port_passes(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import opticomlib_tpu_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "opticomlib_tpu_torchx",
                        types.ModuleType("opticomlib_tpu_torchx"))
    assert run.forbidden_modules() == []


def test_a_loaded_jax_fails_the_run_and_prints_no_result(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "ook_50km.dsp_2e24", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_no_card_refuses_and_prints_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ook_50km.dsp_2e24", "--seed",
                   str(2**32 + 9), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
