"""kmernator_tpu_torch/parallel/bam_exchange.py and bam_sort's distributed
engine: `sort_key` and `global_splitters` equal to the JAX functions at
one process, and `bam_sort --distributed HOST:PORT --nprocs 2` in two
gloo processes against the JAX app in two jax.distributed processes of
one CPU device each (so that both bin by D = 2).

On one reference the two give byte-identical BAMs. On several they give
the same header and decompressed record stream, that of one process, but
not the same BGZF sections: the JAX `global_splitters` allgathers its
int64 sample with `process_allgather`, which without jax_enable_x64
returns int32, so every splitter loses the reference id and the last
rank takes the records of every reference but the first (ROADMAP fault
3k; the port keeps int64)."""
import gzip
import os
import struct
import sys

import numpy as np
import pytest

from kmernator_tpu.apps import bam_sort as jax_bam_sort
from kmernator_tpu.io import bam as jbam
from kmernator_tpu.parallel import bam_exchange as jex

from kmernator_tpu_torch.io import bam as tbam
from kmernator_tpu_torch.parallel import bam_exchange as tex

from sam_input import make_sam
from torch_ranks import run_ranks
import torch_threads  # noqa: F401


def _two_processes(module, args, extra_env):
    """`python -m module --distributed C --nprocs 2 --procid r args` as
    ranks 0 and 1 of one job (tests/torch_ranks.py)."""
    run_ranks(lambda coord, r: [
        sys.executable, "-m", module, "--distributed", coord, "--nprocs",
        "2", "--procid", str(r)] + args, 2, extra_env)


def _members(path):
    """Decompressed sizes of the BGZF members of a file."""
    data = open(path, "rb").read()
    off, sizes = 0, []
    while off < len(data):
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        sizes.append(struct.unpack_from("<I", data, off + bsize - 4)[0])
        off += bsize
    return sizes


def test_sort_key_and_splitters_at_one_process(tmp_path):
    sam = str(tmp_path / "in.sam")
    make_sam(sam, 2000, seed=5)
    t, j = tbam.load_alignments(sam), jbam.load_alignments(sam)
    keys = tex.sort_key(t)
    assert keys.dtype == np.int64
    assert np.array_equal(keys, jex.sort_key(j))
    assert np.array_equal(np.argsort(keys, kind="stable"),
                          tbam.coordinate_sort_order(t))
    for n_bins in (1, 2, 3, 8):
        for k in (keys, keys[:5], keys[:0]):
            s = tex.global_splitters(k, n_bins)
            assert s.dtype == np.int64 and len(s) == n_bins - 1
            assert np.array_equal(s, jex.global_splitters(k, n_bins))
    blobs = [b"one rank's records"]
    assert tex.exchange_blobs(blobs) == blobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """bam_sort at two processes (port and JAX) and at one (the JAX app
    in this process), with both unmapped outputs, on one and on three
    references."""
    d = tmp_path_factory.mktemp("exchange")
    out = {}
    for n_refs in (1, 3):
        sam = str(d / ("in%d.sam" % n_refs))
        make_sam(sam, 2500, seed=11, n_refs=n_refs)
        bam = str(d / ("in%d.bam" % n_refs))
        with open(bam, "wb") as f:
            f.write(tbam.write_bam(tbam.load_alignments(sam)))
        for name, module, env in (
                ("port", "kmernator_tpu_torch.apps.bam_sort", {}),
                ("jax", "kmernator_tpu.apps.bam_sort", dict(
                    XLA_FLAGS="--xla_force_host_platform_device_count=1")),
                ("one", None, None)):
            prefix = str(d / ("%s%d" % (name, n_refs)))
            args = ["--unmapped-reads", prefix + ".un.fastq.gz",
                    "--unmapped-read-pairs", prefix + ".pairs.fastq.gz",
                    prefix + ".bam", bam]
            if module is None:
                assert jax_bam_sort.run(args) == 0
            else:
                _two_processes(module, (["--device", "cpu"]
                                        if name == "port" else []) + args,
                               env)
            out[name, n_refs] = prefix
    return out


def _read(prefix, suffix):
    return open(prefix + suffix, "rb").read()


@pytest.mark.parametrize("n_refs", [1, 3])
def test_two_processes_give_the_one_process_stream(runs, n_refs):
    one = runs["one", n_refs]
    for name in ("port", "jax"):
        two = runs[name, n_refs]
        assert (gzip.decompress(_read(two, ".bam"))
                == gzip.decompress(_read(one, ".bam")))
        for suffix in (".un.fastq.gz", ".pairs.fastq.gz"):
            assert (gzip.decompress(_read(two, suffix))
                    == gzip.decompress(_read(one, suffix)))
    sections = _members(runs["port", n_refs] + ".bam")
    header = len(tbam.header_bytes(tbam.load_alignments(one + ".bam")))
    assert sections[0] == header and sections[-1] == 0   # header, EOF


def test_two_processes_byte_identical_to_jax_on_one_reference(runs):
    assert _read(runs["port", 1], ".bam") == _read(runs["jax", 1], ".bam")


def test_jax_splitters_lose_the_reference(runs):
    """On three references the port's two sections split the records
    near the middle; the JAX app's first rank holds only records of the
    first reference (fault 3k)."""
    total = sum(_members(runs["one", 3] + ".bam"))
    header = _members(runs["port", 3] + ".bam")[0]
    bd = tbam.load_alignments(runs["one", 3] + ".bam")
    first_ref = tbam.records_blob(bd, np.flatnonzero(bd.ref_id == 0))

    def rank0_bytes(prefix):
        sizes = _members(prefix + ".bam")[1:-1]   # header, EOF
        # rank 0's section: BGZF blocks of 65,280 bytes and its last one
        n = 0
        for s in sizes:
            n += s
            if s < 0xFF00:
                return n
        return n

    port0 = rank0_bytes(runs["port", 3])
    jax0 = rank0_bytes(runs["jax", 3])
    body = total - header
    assert 0.3 * body < port0 < 0.7 * body
    assert jax0 <= len(first_ref) < 0.5 * body
