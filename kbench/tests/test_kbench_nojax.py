"""The no-JAX check compares whole top-level module names."""
from kbench import nojax


def test_port_passes():
    assert nojax.found(["kmernator_tpu_torch.apps",
                        "kmernator_tpu_torch"]) == []


def test_jax_and_the_jax_package_fail():
    for name in ("kmernator_tpu.apps", "jax", "jaxlib.xla_client",
                 "flax.linen"):
        assert nojax.found([name]) == [name]


def test_this_process_holds_none():
    import kbench.harness  # noqa: F401
    import kmernator_tpu_torch.apps.filter_reads  # noqa: F401
    assert nojax.found() == []
