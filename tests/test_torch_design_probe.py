"""design_probe.py on the CPU: every probe's patches still apply to the
shipped kernel sources (a probe whose text left the source would measure
nothing), and the script fails without a card. Its measurements run on the
card only."""
import importlib.util
import os

import pytest
import torch

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "design_probe", os.path.join(REPO, "design_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dp = _probe_module()
PROBES = [("run_length", n, p) for n, p in dp.RUN_LENGTH_PROBES.items()] + [
    ("merge_sort", n, p) for n, p in dp.MERGE_PROBES.items()]


@pytest.mark.parametrize("source,name,patches", PROBES,
                         ids=[n for _, n, _ in PROBES])
def test_probe_patches_apply(source, name, patches):
    with open(os.path.join(REPO, "kmernator_tpu_torch", "csrc",
                           source + ".cu")) as f:
        shipped = f.read()
    text = dp.patch_source(source, name, patches)
    assert text != shipped
    for old, new in patches:
        assert new in text


def test_probe_patch_missing_text_raises():
    with pytest.raises(ValueError, match="is not in csrc/run_length.cu"):
        dp.patch_source("run_length", "broken", [("no such text", "x")])


def test_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dp.main() == 2
    assert capsys.readouterr().out == ""
