"""Probes wrap a function under every name the port binds it to, count
each outermost call once, and name a target that has gone."""
import kmernator_tpu_torch.parallel.mesh as mesh
import kmernator_tpu_torch.parallel.mesh_stream as mesh_stream
import kmernator_tpu_torch.parallel.run_length as run_length
import torch

from kbench.probes import ProbeSet


def test_every_binding_is_wrapped_and_restored():
    plain = run_length.run_length_sums
    ps = ProbeSet(device="cpu")
    ps.add("rl", "cuda", ["kmernator_tpu_torch.parallel.run_length:"
                          "run_length_sums"],
           nbytes=lambda a, kw, r: r.numel() * r.element_size())
    ps.install()
    try:
        assert mesh.run_length_sums is not plain
        assert mesh_stream.run_length_sums is mesh.run_length_sums
        ps.begin_job(0.0)
        keys = torch.tensor([1, 1, 2], dtype=torch.int64)
        out = mesh.run_length_sums([keys], torch.ones(3, dtype=torch.int32))
        r = ps.end_job()["rl"]
        assert out.tolist() == [0, 2, 1]
        assert r["calls"] == 1 and r["bytes"] == 12 and r["span_ms"] > 0
    finally:
        ps.uninstall()
    assert mesh.run_length_sums is plain
    assert run_length.run_length_sums is plain


def test_nested_calls_count_once():
    ps = ProbeSet(device="cpu")
    p = ps.add("fact", "host", [])

    def fact(n):
        return 1 if n <= 1 else n * wrapped(n - 1)
    wrapped = ps._wrap(p, fact)
    ps.begin_job(0.0)
    assert wrapped(5) == 120
    assert p.calls == 1 and p.depth == 0


def test_missing_target_is_named():
    ps = ProbeSet(device="cpu")
    ps.add("gone", "host", ["kmernator_tpu_torch.parallel.mesh:no_such_fn",
                            "kmernator_tpu_torch.no_such_module:f"])
    ps.install()
    r = ps.end_job()["gone"]
    assert len(r["missing"]) == 2 and r["calls"] == 0
