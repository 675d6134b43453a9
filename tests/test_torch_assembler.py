"""The port's DistributedNucleatingAssembler and ContigExtender (`--device
cpu`) against the JAX apps, and the copied ops they run (align, vmatch,
external, extend) against the JAX functions.

Inputs are built here: paired phiX reads sampled with numpy from
kmernator_tpu_torch/data/phix174.fasta (1,600 reads of 76 bp, 0.2%
substitutions) with five 76 bp seeds cut from the genome, and a small
`generate_metagenome` read set whose seeds are the first 100 bp of reads
drawn with numpy (as chip_smoke.py draws them at full size). Tolerance:
none. Contig files are byte-identical to the JAX app's on the same engine
(the host k-mer index, the vmatch seed index at k = 0, and `--mesh 1`, whose
read index the port builds with torch on the CPU here), the port's
`--mesh 1` byte-identical to its own host engine, and the copied ops
return what the JAX ones return on the same inputs.
"""
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kmernator_tpu.apps import contig_extender as jax_extender
from kmernator_tpu.apps import nucleating_assembler as jax_asm
from kmernator_tpu.apps.generate_metagenome import run as generate
import kmernator_tpu.io.reads as jax_reads
import kmernator_tpu.ops.align as jax_align
import kmernator_tpu.ops.extend as jax_extend
import kmernator_tpu.ops.external as jax_external
import kmernator_tpu.ops.vmatch as jax_vmatch
from kmernator_tpu_torch.apps import contig_extender as torch_extender
from kmernator_tpu_torch.apps import nucleating_assembler as torch_asm
import kmernator_tpu_torch.io.reads as torch_reads
import kmernator_tpu_torch.ops.align as torch_align
import kmernator_tpu_torch.ops.extend as torch_extend
import kmernator_tpu_torch.ops.external as torch_external
import kmernator_tpu_torch.ops.vmatch as torch_vmatch
from kmernator_tpu_torch.parallel import dist_match

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# the artifact screen at edit distance 1: its distance-2 table takes
# seconds to build on every run, the rest of the app milliseconds
FLAGS = ["--max-iterations", "2", "--artifact-edit-distance", "1"]


def phix_genome() -> bytes:
    with open(os.path.join(REPO, "kmernator_tpu_torch", "data",
                           "phix174.fasta"), "rb") as f:
        return b"".join(l.strip() for l in f if not l.startswith(b">"))


def _revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]


def _write_phix(path_fq, path_seeds, n_pairs=800, dup_pairs=0):
    """Pairs of 76 bp reads from fragments of 200-400 bp of the circular
    genome (read 2 reverse-complemented), 0.2% substitutions, phred 25-40
    with 0.2% of the bases at phred 2; the first dup_pairs pairs written
    twice more under new names (duplicate fragments); five seeds."""
    rng = np.random.default_rng(5)
    g = phix_genome()
    circ = g + g[:1000]
    pairs = []
    for i in range(n_pairs):
        s = int(rng.integers(0, len(g)))
        frag = int(rng.integers(200, 400))
        mates = []
        for seq in (circ[s:s + 76], _revcomp(circ[s + frag - 76:s + frag])):
            seq = bytearray(seq)
            for e in np.nonzero(rng.random(76) < 0.002)[0]:
                seq[e] = ACGT[(b"ACGT".index(seq[e]) + 1) % 4]
            q = rng.integers(25, 41, 76)
            q[rng.random(76) < 0.002] = 2
            mates.append((bytes(seq), bytes((q + 33).astype(np.uint8))))
        pairs.append(mates)
    pairs += [pairs[i % dup_pairs] for i in range(2 * dup_pairs)]
    with open(path_fq, "wb") as f:
        for i, mates in enumerate(pairs):
            for tag, (seq, qual) in enumerate(mates, 1):
                f.write(b"@p%04d/%d\n%s\n+\n%s\n" % (i, tag, seq, qual))
    with open(path_seeds, "wb") as f:
        for i in range(5):
            s = int(rng.integers(0, len(g) - 76))
            f.write(b">seed%d\n%s\n" % (i, g[s:s + 76]))


def draw_seeds(fastq, path, n_seeds, length=100, seed=3):
    """The first `length` bases of n_seeds reads of the FASTQ, drawn with
    numpy.random.default_rng(seed), as FASTA."""
    with open(fastq, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    seqs = [s for s in seqs if s]
    pick = np.random.default_rng(seed).choice(len(seqs), n_seeds,
                                             replace=False)
    with open(path, "wb") as f:
        for i, r in enumerate(pick):
            f.write(b">seed%d\n%s\n" % (i, seqs[r][:length]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("asm")
    out = {}
    _write_phix(str(d / "phix.fastq"), str(d / "phix.fa"))
    out["phix"] = (str(d / "phix.fastq"), str(d / "phix.fa"))
    _write_phix(str(d / "dup.fastq"), str(d / "dup.fa"), n_pairs=400,
                dup_pairs=100)
    out["dup"] = (str(d / "dup.fastq"), str(d / "dup.fa"))
    meta = str(d / "meta.fastq")
    assert generate(["--genomes", "3", "--total-genome-mb", "0.01",
                     "--coverage", "30", "--read-length", "150",
                     "--seed", "7", "--out", meta]) in (0, None)
    draw_seeds(meta, str(d / "meta.fa"), 6)
    out["meta"] = (meta, str(d / "meta.fa"))
    return out


ENGINES = {"host": [], "mesh1": ["--mesh", "1"]}


def _run_pair(tmp_path, inp, k, engine):
    """The JAX app and the port on one engine; returns both outputs."""
    fq, seeds = inp
    common = ["--contig-file", seeds] + FLAGS
    jax_out, torch_out = str(tmp_path / "jax.fa"), str(tmp_path / "torch.fa")
    jax_flags = ENGINES[engine] + (["--jax-platform", "cpu"]
                                   if engine == "mesh1" else [])
    assert jax_asm.run(common + jax_flags + ["--out", jax_out, str(k),
                                             fq]) == 0
    assert torch_asm.run(["--device", "cpu"] + common + ENGINES[engine]
                         + ["--out", torch_out, str(k), fq]) == 0
    return open(jax_out, "rb").read(), open(torch_out, "rb").read()


@pytest.mark.parametrize("name,k,engine", [
    (name, k, engine) for name in ("phix", "meta") for k in (31, 45)
    for engine in sorted(ENGINES)] + [("phix", 0, "host")])
def test_assembler_byte_identical(tmp_path, inputs, name, k, engine,
                                  monkeypatch):
    """The contig file is byte-identical to the JAX app's on the same
    engine (k = 0 is the vmatch seed index); `--mesh 1` also to the port's
    own host engine, and its index is built once on the CPU."""
    built = []

    class Recorded(dist_match.MeshReadIndex):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(dist_match, "MeshReadIndex", Recorded)
    want, got = _run_pair(tmp_path, inputs[name], k, engine)
    assert got == want
    assert got.count(b">") == (5 if name == "phix" else 6)
    assert b"-l" in got            # some seed grew
    if engine == "mesh1":
        assert len(built) == 1 and len(built[0]._shards) == 1
        lanes, rid = built[0]._shards[0]
        assert rid.numel() > 1000 and lanes[0].device.type == "cpu"
        host = str(tmp_path / "host.fa")
        assert torch_asm.run(["--device", "cpu", "--contig-file",
                              inputs[name][1]] + FLAGS
                             + ["--out", host, str(k), inputs[name][0]]) == 0
        assert open(host, "rb").read() == got
    else:
        assert not built


def test_phix_contigs_stay_on_the_genome(tmp_path, inputs):
    """`--mesh 1` contigs are exact substrings of the circular phiX genome
    (either strand), and most seeds grow with -l<n>r<m> names."""
    fq, seeds = inputs["phix"]
    out = str(tmp_path / "mesh.fa")
    assert torch_asm.run(["--device", "cpu", "--mesh", "1", "--contig-file",
                          seeds] + FLAGS + ["--out", out, "31", fq]) == 0
    lines = open(out, "rb").read().split()
    contigs = dict(zip(lines[0::2], lines[1::2]))
    assert len(contigs) == 5
    g = phix_genome()
    circ, circ_rc = g + g[:1000], _revcomp(g) + _revcomp(g)[:1000]
    grew = 0
    for name, seq in contigs.items():
        assert seq in circ or seq in circ_rc, name
        if len(seq) > 76:
            grew += 1
            assert b"-l" in name and b"r" in name.rsplit(b"-l", 1)[1]
    assert grew >= 4


@pytest.mark.parametrize("dedup", [False, True])
def test_contig_extender_byte_identical(tmp_path, inputs, dedup, capfd):
    """ContigExtender byte-identical to the JAX app, and with --dedup-mode 1
    on reads holding duplicate fragments (both apps log the same number of
    reads removed, more than 0)."""
    fq, seeds = inputs["dup"]
    flags = ["--contig-file", seeds, "--verbose", "1"]
    if dedup:
        flags += ["--dedup-mode", "1"]
    jax_out, torch_out = str(tmp_path / "jax.fa"), str(tmp_path / "torch.fa")
    assert jax_extender.run(flags + ["--out", jax_out, "25", fq]) == 0
    jax_log = capfd.readouterr().err
    assert torch_extender.run(["--device", "cpu"] + flags
                              + ["--out", torch_out, "25", fq]) == 0
    torch_log = capfd.readouterr().err
    got = open(torch_out, "rb").read()
    assert got == open(jax_out, "rb").read()
    assert got.count(b">") == 5 and b"-l" in got

    def removed(log):
        return [l.rsplit(":", 1)[1].strip() for l in log.splitlines()
                if "removed duplicate fragment" in l]

    assert removed(torch_log) == removed(jax_log)
    if dedup:
        assert int(removed(torch_log)[0]) > 0


def test_refusals(tmp_path, inputs):
    """k > 96 on --mesh 2 and --mesh 1 is refused before the input is read
    (--mesh N itself runs N shards); --device takes cuda or cpu, and cuda
    without a visible GPU raises (nothing falls back to the CPU)."""
    seeds = inputs["phix"][1]
    base = ["--contig-file", seeds, "--out", str(tmp_path / "o")]
    with pytest.raises(NotImplementedError, match="k=97"):
        torch_asm.run(["--device", "cpu", "--mesh", "2"] + base
                      + ["97", "missing.fq"])
    with pytest.raises(NotImplementedError, match="k=97"):
        torch_asm.run(["--device", "cpu", "--mesh", "1"] + base
                      + ["97", "missing.fq"])
    for app in (torch_asm, torch_extender):
        with pytest.raises(ValueError, match="--device"):
            app.run(["--device", "tpu"] + base + ["31", "missing.fq"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                app.run(base + ["31", "missing.fq"])


# --------------------------------------------------------------------------
# the copied ops, each case run on both packages
# --------------------------------------------------------------------------

PKGS = {
    "jax": SimpleNamespace(reads=jax_reads, align=jax_align,
                           vmatch=jax_vmatch, external=jax_external,
                           extend=jax_extend),
    "torch": SimpleNamespace(reads=torch_reads, align=torch_align,
                             vmatch=torch_vmatch, external=torch_external,
                             extend=torch_extend)}


def _aln(a):
    return (a.target.start, a.target.end, a.query.start, a.query.end,
            a.mismatches, a.overlap, a.identity, a.query.reversed)


def case_kmer_aligner(m, _):
    """tests/test_align_consensus.py::test_kmer_aligner."""
    rng = np.random.default_rng(1)
    g = "".join(rng.choice(list("ACGT"), 500))
    a = m.align.KmerAligner(g[:300].encode(), 21)
    aln = a.align(g[250:400].encode())
    assert aln.overlap == 50 and aln.mismatches == 0 and aln.identity == 1.0
    aln2 = a.align(m.align.revcomp(g[250:400].encode()))
    assert aln2.overlap == 50 and aln2.query.reversed
    q3 = bytearray(g[240:320].encode())
    q3[40] ^= 6
    aln3 = a.align(bytes(q3))
    assert aln3.overlap == 60 and aln3.mismatches == 1
    return [_aln(x) for x in (aln, aln2, aln3)]


def case_vmatch_options(m, _):
    p = m.vmatch.parse_vmatch_options
    out = [p("-d -p -seedlength 10 -l 50 -e 3"), p("-seedlength 12 -l 40 -e 1")]
    assert out == [(10, 50, 3), (12, 40, 1)]
    return out


def case_banded_edit_distance(m, _):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 4, 60).astype(np.uint8)
    b = a.copy()
    b[10] = (b[10] + 1) % 4
    b[40] = (b[40] + 1) % 4
    c = np.delete(a, 25)
    d = rng.integers(0, 4, 60).astype(np.uint8)
    out = [m.vmatch.banded_edit_distance(a, x, 3) for x in (a, b, c, d)]
    assert out == [0, 2, 1, 4]
    return out


def _codes(m, s: bytes):
    return m.reads.BASE_CODE[np.frombuffer(s, np.uint8)].astype(np.uint8)


def _mutate(s: bytes, positions) -> bytes:
    out = bytearray(s)
    for p in positions:
        out[p] = b"CGTA"[b"ACGT".index(out[p])]
    return bytes(out)


def case_vmatch_strands_and_errors(m, _):
    phix = phix_genome()
    rng = np.random.default_rng(3)
    rs = m.reads.ReadSet()
    rs.append_read(b"fwd", b"", phix[1050:1126], None)
    rs.append_read(b"rc3", b"", _revcomp(
        _mutate(phix[1200:1276], [10, 40, 60])), None)
    rs.append_read(b"bad", b"", _mutate(phix[1100:1176],
                                        [5, 17, 29, 41, 53, 65]), None)
    rs.append_read(b"rand", b"", ACGT[rng.integers(0, 4, 76)].tobytes(),
                   None)
    rs.append_read(b"short", b"", phix[1360:1400]
                   + ACGT[rng.integers(0, 4, 36)].tobytes(), None)
    got = m.vmatch.SeedReadIndex(rs, 10, 50, 3).match_contig(
        _codes(m, phix[1000:1400]))
    assert got == {0, 1}
    return sorted(got)


def case_vmatch_discarded_reads(m, _):
    phix = phix_genome()
    rs = m.reads.ReadSet()
    rs.append_read(b"a", b"", phix[100:176], None)
    rs.append_read(b"b", b"", phix[120:196], None)
    rs.discarded[1] = True
    got = m.vmatch.SeedReadIndex(rs, 10, 50, 3).match_contig(
        _codes(m, phix[80:300]))
    assert got == {0}
    return sorted(got)


def case_extend_helpers(m, _):
    """get_min_max_kmer_size, new_contig_name, extend_contigs on a read set
    that covers a seed."""
    g = phix_genome()
    rs = m.reads.ReadSet()
    for s in range(200, 700, 7):
        rs.append_read(b"r%d" % s, b"", g[s:s + 76], np.full(76, 35))
    contigs = m.reads.ReadSet()
    contigs.append_read(b"c", b"", g[400:476], None)
    ext = m.extend.extend_contigs(contigs, rs, m.extend.ExtendParams(), 21)
    assert len(ext.get_seq(0)) > 76
    return [m.extend.get_min_max_kmer_size(rs, 21),
            m.extend.new_contig_name(b"c-l3r4", 2, 5),
            m.extend.new_contig_name(b"c", 0, 0),
            ext.names[0], ext.get_seq(0)]


_rng = np.random.default_rng(5)
CONTIG = ACGT[_rng.integers(0, 4, 80)].tobytes()
EXTENDED = (ACGT[_rng.integers(0, 4, 25)].tobytes() + CONTIG
            + ACGT[_rng.integers(0, 4, 30)].tobytes())
UNRELATED = ACGT[_rng.integers(0, 4, 200)].tobytes()


def _pool(m):
    rs = m.reads.ReadSet()
    for i in range(4):
        s = EXTENDED[i * 10:i * 10 + 60]
        rs.append_read(b"r%d" % i, b"", s, np.full(len(s), 30))
    return rs


def _stub(bin_dir, name, script):
    path = os.path.join(bin_dir, name)
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def case_cap3_picks_containing_contig(m, bin_dir):
    """tests/test_external_assembler.py, the stub cap3 cases."""
    _stub(bin_dir, "cap3", """#!/bin/sh
grep -q '^>seed1$' "$1" || exit 1
grep -q '^>r0$' "$1" || exit 1
cat > "$1.cap.contigs" <<EOF
>Contig1
%s
>Contig2
%s
EOF
""" % (EXTENDED.decode(), UNRELATED.decode()))
    asm = m.external.Cap3(m.external.ExternalOptions())
    assert asm.is_available()
    got = asm.extend_contig(b"seed1", CONTIG, _pool(m))
    assert got == (b"Contig1", EXTENDED)
    return got


def case_cap3_keeps_original(m, bin_dir):
    out = []
    for script in ("#!/bin/sh\ncat > \"$1.cap.contigs\" <<EOF\n>Contig1\n"
                   "%s\nEOF\n" % UNRELATED.decode(), "#!/bin/sh\nexit 0\n"):
        _stub(bin_dir, "cap3", script)
        asm = m.external.Cap3(m.external.ExternalOptions())
        out.append(asm.extend_contig(b"seed1", CONTIG, _pool(m)))
    assert out == [(b"seed1", CONTIG)] * 2
    return out


def case_newbler_layout_and_flags(m, bin_dir):
    _stub(bin_dir, "runAssembly", """#!/bin/sh
echo "$@" | grep -q -- "-ml 40" || exit 1
echo "$@" | grep -q -- "-mi 90" || exit 1
out=""
while [ $# -gt 1 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
mkdir -p "$out"
cat > "$out/454AllContigs.fna" <<EOF
>ext
%s
EOF
""" % EXTENDED.decode())
    asm = m.external.Newbler(m.external.ExternalOptions())
    assert asm.is_available()
    got = asm.extend_contig(b"seed1", CONTIG, _pool(m))
    assert got == (b"ext", EXTENDED)
    return got


def case_unavailable_binary_raises(m, bin_dir):
    asm = m.external.Cap3(m.external.ExternalOptions())
    assert not asm.is_available()
    with pytest.raises(RuntimeError):
        asm.extend_contig(b"s", CONTIG, _pool(m))
    return asm.binary


CASES = {f.__name__[5:]: f for f in (
    case_kmer_aligner, case_vmatch_options, case_banded_edit_distance,
    case_vmatch_strands_and_errors, case_vmatch_discarded_reads,
    case_extend_helpers, case_cap3_picks_containing_contig,
    case_cap3_keeps_original, case_newbler_layout_and_flags,
    case_unavailable_binary_raises)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copied_ops_equal_jax(tmp_path, monkeypatch, case):
    """Each case of the JAX package's align, vmatch and external-assembler
    tests (and the extender's helpers) on the port's copy and on the JAX
    function: the same result, and the assertions of the JAX test hold on
    both. The external cases run stub binaries from a directory that alone
    stands on PATH beside the system's."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    path = str(bin_dir)
    if case != "unavailable_binary_raises":
        path += os.pathsep + os.environ["PATH"]
    monkeypatch.setenv("PATH", path)
    results = {name: CASES[case](m, str(bin_dir)) for name, m in PKGS.items()}
    assert results["torch"] == results["jax"]
