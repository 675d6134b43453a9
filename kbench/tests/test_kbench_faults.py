"""The check catches the faults a cell can have: a run with the timed path
broken underneath comes out not correct. The harness's look for a card is
skipped (device cpu); the rest of a run is driven as it stands."""
import os

import pytest
import torch

from kbench.tests.common import run_cpu
import kmernator_tpu_torch.apps.filter_reads as fr
import kmernator_tpu_torch.apps.meraculous_counter as mc
from kmernator_tpu_torch.parallel import mesh, mesh_stream


def _zeros(lanes, vals):
    return torch.zeros_like(vals)


def _half(fn, arg):
    """fn with its argument `arg` (a [B, ...] mask) false past B/2."""
    def call(*a, **kw):
        a = list(a)
        m = a[arg].copy() if hasattr(a[arg], "copy") else a[arg].clone()
        m[m.shape[0] // 2:] = False
        a[arg] = m
        return fn(*a, **kw)
    return call


def _altered(fn):
    """select_reads with one byte of its first output changed."""
    def call(*a, **kw):
        out = fn(*a, **kw)
        for path, data in out.items():
            out[path] = data[:-2] + (b"A" if data[-2:-1] != b"A" else b"C") \
                + data[-1:]
            break
        return out
    return call


def _altered_file(fn):
    """dump_counts with one byte of its file changed."""
    def call(spectrum, path, *a, **kw):
        fn(spectrum, path, *a, **kw)
        with open(path, "r+b") as f:
            c = f.read(1)
            f.seek(0)
            f.write(b"C" if c != b"C" else b"A")
    return call


FILTER = {
    "state unchanged": lambda mp: mp.setattr(
        mesh_stream.MeshStreamingSpectrum, "add_batch",
        lambda self, *a, **kw: None),
    "half the batch": lambda mp: mp.setattr(
        mesh_stream.MeshStreamingSpectrum, "add_batch",
        _half(mesh_stream.MeshStreamingSpectrum.add_batch, 2)),
    "run sums zero": lambda mp: mp.setattr(mesh_stream, "run_length_sums",
                                           _zeros),
    "answer altered": lambda mp: mp.setattr(fr, "select_reads",
                                            _altered(fr.select_reads)),
}
MERACULOUS = {
    "half the batch": lambda mp: mp.setattr(
        mc, "extension_spectrum_mesh", _half(mc.extension_spectrum_mesh, 3)),
    "run sums zero": lambda mp: mp.setattr(mesh, "run_length_sums", _zeros),
    "answer altered": lambda mp: mp.setattr(mc, "dump_counts",
                                            _altered_file(mc.dump_counts)),
}


@pytest.mark.parametrize("fault", list(FILTER))
def test_filter_fault_is_caught(fault, monkeypatch):
    FILTER[fault](monkeypatch)
    res = run_cpu("filter-k31.meta20x")["result"]
    assert not res["correct"]


@pytest.mark.parametrize("fault", list(MERACULOUS))
def test_meraculous_fault_is_caught(fault, monkeypatch):
    MERACULOUS[fault](monkeypatch)
    res = run_cpu("meraculous-k21.meta20x")["result"]
    assert not res["correct"]


PLANTS = {
    "exchange left out": "from kmernator_tpu_torch.parallel import mesh\n"
                         "mesh.all_to_all_planes = lambda planes: planes\n",
    "half the batch": "from kmernator_tpu_torch.parallel import mesh_stream\n"
                      "S = mesh_stream.MeshStreamingSpectrum\n"
                      "add = S.add_batch\n"
                      "def half(self, codes, good2d, *a, **kw):\n"
                      "    good2d = good2d.copy()\n"
                      "    good2d[good2d.shape[0] // 2:] = False\n"
                      "    return add(self, codes, good2d, *a, **kw)\n"
                      "S.add_batch = half\n",
}


@pytest.mark.parametrize("fault", list(PLANTS))
def test_ranks_fault_is_caught(fault, monkeypatch, tmp_path):
    plant = os.path.join(tmp_path, "plant.py")
    with open(plant, "w") as f:
        f.write(PLANTS[fault])
    monkeypatch.setenv("KBENCH_PLANT", plant)
    res = run_cpu("filter-k31.meta20x", ranks=2,
                  config="filterp-k31-4rank")["result"]
    assert not res["correct"]
