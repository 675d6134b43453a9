"""kmernator_tpu_torch.entry, the twin of __graft_entry__.py: entry() on
the CPU gives the JAX entry's counts bit for bit (tolerance: none), and
dryrun_multichip runs to its end with every assert at 1, 2 and 4 shards
of the CPU (the JAX dryrun's steps: the three distributed_*_fn, the
streaming shard tables and their lookup, the read matcher, and
FilterReads at --mesh n and --streaming --distributed --nprocs 1
byte-identical to its host engine)."""
import numpy as np
import pytest

import __graft_entry__ as G
from kmernator_tpu_torch import entry as E

import torch_threads  # noqa: F401


def test_entry_bit_equal_to_jax():
    jfn, jargs = G.entry()
    fn, args = E.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(jargs, args):
        assert np.array_equal(np.asarray(a), b.numpy())
    got = fn(*args)
    assert tuple(got.shape) == (256, 70)
    assert np.array_equal(np.asarray(jfn(*jargs)), got.numpy())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_the_cpu(n):
    E.dryrun_multichip(n, device="cpu")


def test_main_refuses_unknown_arguments(capsys):
    assert E.main(["--mesh", "2"]) == 2
    assert "usage" in capsys.readouterr().err
