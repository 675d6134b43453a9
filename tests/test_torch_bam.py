"""kmernator_tpu_torch/io/bam.py and the BAM apps (bam_sort's host engine,
filter_and_sort_sam) against the JAX package's, on seeded SAM input built
inside the repo (tests/sam_input.py): every function's output equal or
byte-equal, and every app's output byte-identical (the gzip outputs after
decompression: gzip stamps its header with the time of writing)."""
import gzip
import struct

import numpy as np
import pytest

from kmernator_tpu.apps import bam_sort as jax_bam_sort
from kmernator_tpu.apps import filter_and_sort_sam as jax_filter_sam
from kmernator_tpu.io import bam as jbam

from kmernator_tpu_torch.apps import bam_sort
from kmernator_tpu_torch.apps import filter_and_sort_sam
from kmernator_tpu_torch.io import bam as tbam

from sam_input import make_sam
import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bam")
    sam = str(d / "in.sam")
    make_sam(sam, 3000, seed=3)
    bam = str(d / "in.bam")
    with open(bam, "wb") as f:
        f.write(jbam.write_bam(jbam.load_alignments(sam)))
    sam2 = str(d / "second.sam")   # same references, other records
    make_sam(sam2, 700, seed=3, unmapped=0.3)
    return {"sam": sam, "bam": bam, "sam2": sam2, "dir": d}


def same_data(a, b):
    assert a.header_text == b.header_text
    assert a.ref_names == b.ref_names and a.ref_lens == b.ref_lens
    assert a.records == b.records
    for col in ("ref_id", "pos", "flag"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col


def test_parse_and_write_byte_equal(inputs):
    raw = open(inputs["sam"], "rb").read()
    j, t = jbam.parse_sam(raw), tbam.parse_sam(raw)
    same_data(j, t)
    assert t.n == 3000
    order = tbam.coordinate_sort_order(t)
    assert np.array_equal(order, jbam.coordinate_sort_order(j))
    for o in (None, order, order[::7]):
        data = tbam.write_bam(t, o)
        assert data == jbam.write_bam(j, o)
        same_data(tbam.parse_bam(data), jbam.parse_bam(data))
    same_data(tbam.load_alignments(inputs["bam"]),
              jbam.load_alignments(inputs["bam"]))
    with pytest.raises(ValueError):
        tbam.parse_bam(gzip.compress(b"not a BAM"))


def test_bgzf_byte_equal():
    payload = np.random.default_rng(1).integers(
        0, 4, 200_000, dtype=np.uint8).tobytes()
    for eof in (True, False):
        for data in (b"", payload):
            z = tbam.bgzf_compress(data, eof=eof)
            assert z == jbam.bgzf_compress(data, eof=eof)
            assert tbam.bgzf_decompress(z) == data
    assert tbam.BGZF_EOF == jbam.BGZF_EOF


def test_records_blob_round_trip(inputs):
    j = jbam.load_alignments(inputs["bam"])
    t = tbam.load_alignments(inputs["bam"])
    assert tbam.header_bytes(t) == jbam.header_bytes(j)
    for sel in (np.arange(t.n), np.arange(t.n)[::-3], np.zeros(0, np.int64)):
        blob = tbam.records_blob(t, sel)
        assert blob == jbam.records_blob(j, sel)
        same_data(tbam.parse_records_blob(blob, t),
                  jbam.parse_records_blob(blob, j))


def test_sam_text_with_aux_tags(inputs):
    """record_to_sam decodes every aux type; parse_sam writes none, so the
    tags are appended to the record bodies here."""
    aux = (b"XAAQ" + b"NMC\x07" + b"XCc\xfe" + struct.pack("<2sch", b"XS",
           b"s", -300) + struct.pack("<2scH", b"XT", b"S", 60000)
           + struct.pack("<2sci", b"XI", b"i", -70000)
           + struct.pack("<2scI", b"XU", b"I", 3_000_000_000)
           + struct.pack("<2scf", b"XF", b"f", 0.25) + b"MDZ10A5\x00"
           + b"XHH1AE3\x00" + struct.pack("<2scci3h", b"XB", b"B", b"s", 3,
                                          -1, 2, 3)
           + struct.pack("<2scci2f", b"XG", b"B", b"f", 2, 0.5, -1.5)
           + b"XQ?")   # an unknown type ends the tags
    j = jbam.load_alignments(inputs["bam"])
    t = tbam.load_alignments(inputs["bam"])
    for bd in (j, t):
        bd.records = [r + aux if i % 5 == 0 else r
                      for i, r in enumerate(bd.records)]
    order = tbam.coordinate_sort_order(t)
    text = tbam.to_sam_text(t, order)
    assert text == jbam.to_sam_text(j, order)
    assert b"XB:B:s,-1,2,3" in text and b"XU:i:3000000000" in text
    assert tbam.to_sam_text(t) == jbam.to_sam_text(j)
    for i in (0, 1, 17):
        assert tbam.record_to_sam(t, i) == jbam.record_to_sam(j, i)
        assert t.seq_qual(i) == j.seq_qual(i) and t.name(i) == j.name(i)


def test_merge_equal(inputs):
    paths = [inputs["sam"], inputs["bam"], inputs["sam2"]]
    same_data(tbam.merge([tbam.load_alignments(p) for p in paths]),
              jbam.merge([jbam.load_alignments(p) for p in paths]))
    other = tbam.load_alignments(inputs["bam"])
    other.ref_names = other.ref_names[:1]
    with pytest.raises(ValueError):
        tbam.merge([tbam.load_alignments(inputs["bam"]), other])


def _small_bam(inputs, n):
    path = str(inputs["dir"] / ("small%d.bam" % n))
    bd = tbam.load_alignments(inputs["sam"])
    bd.records, bd.ref_id = bd.records[:n], bd.ref_id[:n]
    bd.pos, bd.flag = bd.pos[:n], bd.flag[:n]
    with open(path, "wb") as f:
        f.write(tbam.write_bam(bd))
    return path


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_partitioned_load_covers_the_stream(inputs, size):
    """Each rank's share equals the JAX function's, with the same bytes
    read, and the shares in rank order give the whole record stream; a
    file of one BGZF block leaves the ranks past its first empty; SAM
    takes the record-range split."""
    for path in (inputs["bam"], _small_bam(inputs, 3), inputs["sam"]):
        whole = tbam.load_alignments(path)
        records = []
        for rank in range(size):
            st_t, st_j = {}, {}
            t = tbam.load_alignments_partitioned(path, rank, size, stats=st_t)
            j = jbam.load_alignments_partitioned(path, rank, size, stats=st_j)
            same_data(t, j)
            assert st_t == st_j
            records += t.records
            if path.endswith("small3.bam") and rank:
                assert t.n == 0
        assert records == whole.records


def test_to_fastq_equal(inputs):
    t = tbam.load_alignments(inputs["bam"])
    j = jbam.load_alignments(inputs["bam"])
    for i in range(0, t.n, 13):
        assert bam_sort.to_fastq(t, i) == jax_bam_sort.to_fastq(j, i)


def _outputs(paths):
    out = []
    for p in paths:
        data = open(p, "rb").read()
        out.append(gzip.decompress(data) if p.endswith(".gz") else data)
    return out


@pytest.mark.parametrize("ext,unmapped,keep", [
    ("bam", True, "1"), ("sam", True, "0"), ("bam", False, "0"),
    ("sam", False, "true"), ("bam", True, "false")])
def test_bam_sort_byte_identical(inputs, ext, unmapped, keep):
    d = inputs["dir"]
    runs = []
    for name, run in (("port", bam_sort.run), ("jax", jax_bam_sort.run)):
        out = str(d / ("%s-%s-%d-%s.%s" % (name, ext, unmapped, keep, ext)))
        argv = ["--keep-unmapped-paired-read", keep]
        files = [out]
        if unmapped:
            files += [out + ".unmapped.fastq.gz", out + ".pairs.fastq.gz"]
            argv += ["--unmapped-reads", files[1],
                     "--unmapped-read-pairs", files[2]]
        if name == "port":
            argv = ["--device", "cpu"] + argv
        assert run(argv + [out, inputs["bam"], inputs["sam2"]]) == 0
        runs.append(_outputs(files))
    assert runs[0] == runs[1]
    if ext == "bam":
        sorted_bd = tbam.parse_bam(open(files[0], "rb").read())
        key = sorted_bd.ref_id.astype(np.int64) * (1 << 34) + sorted_bd.pos
        assert (np.diff(key) >= 0).all()
    if unmapped:
        assert runs[0][1] and runs[0][2]


def test_bam_sort_flag_forms(inputs):
    """--output-bam and --input-bams, one output name for two inputs, and
    the usage error."""
    d = inputs["dir"]
    outs = []
    for name, run, dev in (("port", bam_sort.run, ["--device", "cpu"]),
                           ("jax", jax_bam_sort.run, [])):
        out = str(d / ("%s-flags.bam" % name))
        assert run(dev + ["--output-bam", out, "--input-bams", inputs["sam2"],
                          "--num-partitions", "4", inputs["sam"]]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    assert bam_sort.run(["--device", "cpu", "only-output.bam"]) == 1


@pytest.mark.parametrize("flags", [
    ["--exclude-flags", "4", "--min-mapq", "20"],
    ["--require-flags", "65"],
    ["--require-flags", "1", "--exclude-flags", "16"],
    []])
def test_filter_and_sort_sam_byte_identical(inputs, flags):
    d = inputs["dir"]
    outs = []
    for name, run, dev in (("port", filter_and_sort_sam.run,
                            ["--device", "cpu"]),
                           ("jax", jax_filter_sam.run, [])):
        out = str(d / ("%s-fs-%s.bam" % (name, "_".join(flags))))
        assert run(dev + flags + [out, inputs["sam"]]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    assert filter_and_sort_sam.run(["--device", "cpu", "x.bam"]) == 1
