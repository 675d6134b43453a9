"""The port's small host apps against the JAX package's, after the case
list of tests/test_small_apps.py (whose inputs live outside the repo):
fastq2fasta (plain, --split-pairs, --split-size-mbase, the Fastq2FastaQual
round trip), randomly_sample, split_sequence over every file number (and
its --split-file, FIFO and --fork-command paths), compare_spectrums and
estimate_size, each byte-identical to the JAX app on seeded input built
here; and owner_hash_np equal to the JAX function."""
import os
import subprocess
import sys

import numpy as np
import pytest

from kmernator_tpu.apps import compare_spectrums as j_cs
from kmernator_tpu.apps import estimate_size as j_es
from kmernator_tpu.apps import fastq2fasta as j_f2f
from kmernator_tpu.apps import randomly_sample as j_rs
from kmernator_tpu.apps import split_sequence as j_ss

from kmernator_tpu_torch.apps import compare_spectrums as t_cs
from kmernator_tpu_torch.apps import estimate_size as t_es
from kmernator_tpu_torch.apps import fastq2fasta as t_f2f
from kmernator_tpu_torch.apps import randomly_sample as t_rs
from kmernator_tpu_torch.apps import split_sequence as t_ss
from kmernator_tpu_torch.io.reads import load_reads

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _paired_fastq(path, seed, n_pairs=300, genome_len=5000):
    """Interleaved pairs off one seeded genome (names /1 /2, some in the
    Casava 1.8 comment form), a few singletons, N bases and low
    qualities."""
    rng = np.random.default_rng(seed)
    genome = ACGT[rng.integers(0, 4, genome_len)]
    out = []
    for i in range(n_pairs):
        for mate in (1, 2):
            if i % 17 == 5 and mate == 2:
                continue                       # a singleton
            L = int(rng.integers(40, 101))
            s = int(rng.integers(0, genome_len - L))
            seq = genome[s:s + L].copy()
            seq[rng.random(L) < 0.01] = ord("N")
            qual = (rng.integers(2, 41, L) + 33).astype(np.uint8).tobytes()
            name = (b"p%04d 1:N:0:ACGT" % i if i % 5 == 0 and mate == 1
                    else b"p%04d 2:N:0:ACGT" % i if i % 5 == 0
                    else b"p%04d/%d" % (i, mate))
            out.append(b"@%s\n%s\n+\n%s\n" % (name, seq.tobytes(), qual))
    with open(path, "wb") as f:
        f.write(b"".join(out))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    a, b = str(d / "a.fastq"), str(d / "b.fastq")
    _paired_fastq(a, 1)
    _paired_fastq(b, 2, n_pairs=200)
    fa = str(d / "contigs.fa")
    rng = np.random.default_rng(4)
    with open(fa, "wb") as f:
        for i in range(6):
            f.write(b">c%d\n%s\n" % (i, ACGT[rng.integers(0, 4, 700)]
                                      .tobytes()))
    return {"a": a, "b": b, "fa": fa, "dir": d}


def _both(t_run, j_run, argv_of, files_of):
    """Runs the port app (with --device cpu) and the JAX app, each with its
    own output prefix; returns each side's output files' bytes."""
    got = []
    for name, run, dev in (("port", t_run, ["--device", "cpu"]),
                           ("jax", j_run, [])):
        assert run(dev + argv_of(name)) == 0
        got.append([open(p, "rb").read() for p in files_of(name)])
    assert got[0] == got[1]
    return got[0]


@pytest.mark.parametrize("extra,suffixes", [
    ([], ["-a.fasta"]),
    (["--split-pairs", "1"], ["-a-1.fasta", "-a-2.fasta", "-a.fasta"]),
    (["--split-size-mbase", "0"], ["-a.fasta"]),
    (["--format-output", "0"], ["-a.fastq"]),
    (["--write-qual", "1"], ["-a.fasta", "-a.qual"])])
def test_fastq2fasta_byte_identical(reads, extra, suffixes):
    d = reads["dir"]
    tag = "".join(extra)
    got = _both(t_f2f.run, j_f2f.run,
                lambda n: extra + ["--out", str(d / (n + tag)), reads["a"]],
                lambda n: [str(d / (n + tag)) + s for s in suffixes])
    assert all(got)
    if "--split-pairs" in extra:
        l1, l2 = got[0].split(b"\n"), got[1].split(b"\n")
        assert len(l1) == len(l2)
        assert all(x.endswith(b"/1") or b" 1:N" in x for x in l1[0::2] if x)
        assert all(x.endswith(b"/2") or b" 2:N" in x for x in l2[0::2] if x)


def test_fastq2fasta_qual_round_trip(reads, monkeypatch):
    """main_qual (Fastq2FastaQual): FASTA plus a sibling .qual that
    load_reads takes back to the same bases and qualities."""
    out = str(reads["dir"] / "fq")
    monkeypatch.setattr(sys, "argv", ["Fastq2FastaQual", "--device", "cpu",
                                      "--out", out, reads["a"]])
    with pytest.raises(SystemExit) as e:
        t_f2f.main_qual()
    assert e.value.code == 0

    def records(rs):   # pairs first, singletons after: the order differs
        ph = rs.phred()
        return sorted((rs.names[i], rs.get_seq(i),
                       ph[rs.offsets[i]:rs.offsets[i + 1]].tobytes())
                      for i in range(rs.n))

    a = records(load_reads([out + "-a.fasta"]))
    assert len(a) == 582 and a == records(load_reads([reads["a"]]))


@pytest.mark.parametrize("extra,n_records", [
    (["--num-samples", "7"], None), (["--num-samples", "9", "--by-pair",
                                      "0"], 9),
    (["--num-samples", "5000", "--seed", "3"], 582),
    (["--num-samples", "40", "--by-pair", "0", "--seed", "8"], 40)])
def test_randomly_sample_byte_identical(reads, extra, n_records):
    d = reads["dir"]
    tag = "".join(extra)
    got = _both(t_rs.run, j_rs.run,
                lambda n: extra + ["--out", str(d / (n + tag + ".fq")),
                                   reads["a"]],
                lambda n: [str(d / (n + tag + ".fq"))])
    n = got[0].count(b"\n") // 4
    if n_records is None:   # 7 pairs, a pair with a singleton at most
        assert 13 <= n <= 14
    else:
        assert n == n_records


@pytest.mark.parametrize("num_files", [1, 4])
def test_split_sequence_every_file_num(reads, num_files):
    d = reads["dir"]
    parts = []
    for fn in range(num_files):
        args = ["--num-files", str(num_files), "--file-num", str(fn)]
        got = _both(t_ss.run, j_ss.run,
                    lambda n: args + ["--out", str(d / (n + "{Uniq}.fq")),
                                      reads["a"]],
                    lambda n: [str(d / (n + "%06dof%06d.fq" % (fn,
                                                                num_files)))])
        parts.append(got[0])
    assert b"".join(parts) == open(reads["a"], "rb").read()


@pytest.mark.parametrize("extra", [
    ["--min-read-length", "70"],
    ["--split-file", "{Uniq}-2.fq", "--trim-pair-in-name", "1"],
    ["--second-dim", "2", "--merge", "{Uniq}.fq", "--merge",
     "{UniqFirst}.merged"]])
def test_split_sequence_options(reads, extra, monkeypatch, tmp_path):
    for name, run, dev in (("port", t_ss.run, ["--device", "cpu"]),
                           ("jax", j_ss.run, [])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        for fn in range(4):
            assert run(dev + extra + ["--num-files", "4", "--file-num",
                                      str(fn), "--out", "{Uniq}.fq",
                                      reads["a"]]) == 0
    listing = sorted(os.listdir(tmp_path / "port"))
    assert listing == sorted(os.listdir(tmp_path / "jax"))
    assert len(listing) >= 4
    for f in listing:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def test_split_sequence_fifo_and_fork_command(reads, tmp_path):
    """--output-fifo with a reader started by --fork-command, each app in
    its own process under a time limit (a FIFO with no reader blocks)."""
    outs = []
    for mod in ("kmernator_tpu_torch", "kmernator_tpu"):
        d = tmp_path / mod
        d.mkdir()
        dev = ["--device", "cpu"] if mod == "kmernator_tpu_torch" else []
        proc = subprocess.run(
            [sys.executable, "-m", mod + ".apps.split_sequence"] + dev + [
                "--num-files", "2", "--file-num", "1", "--output-fifo", "1",
                "--out", str(d / "{Uniq}.fifo"), "--fork-command",
                "cat %s > %s" % (d / "{Uniq}.fifo", d / "{FileNum}.out"),
                reads["a"]],
            env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                     **ONE_THREAD),
            capture_output=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert os.listdir(d) == ["000001.out"]   # the FIFO is gone
        outs.append((d / "000001.out").read_bytes())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("case", ["self", "other", "per-read", "circular"])
def test_compare_spectrums_byte_identical(reads, case):
    d = reads["dir"]
    ref, extra = {"self": (reads["a"], []), "other": (reads["b"], []),
                  "per-read": (reads["fa"], ["--per-read", "1"]),
                  "circular": (reads["fa"], ["--circular-reference",
                                             "1"])}[case]
    got = _both(t_cs.run, j_cs.run,
                lambda n: extra + ["--out", str(d / (n + case + ".cs")),
                                   "21", ref, reads["a"]],
                lambda n: [str(d / (n + case + ".cs"))])
    last = got[0].decode().strip().splitlines()[-1].split("\t")
    if case == "self":
        assert last[0] == last[1] == last[2] and float(last[3]) == 100.0
    if case == "other":
        assert int(last[2]) < int(last[0])


@pytest.mark.parametrize("extra", [
    ["--kmer-subsample", "1", "--max-sample-fraction", "0.9",
     "--sample-partitions", "12", "21"],
    ["--sample-partitions", "5", "--kmer-subsample", "3", "31"]])
def test_estimate_size_equal(reads, extra):
    d = reads["dir"]
    tag = "".join(extra)
    got = _both(t_es.run, j_es.run,
                lambda n: extra[:-1] + ["--out", str(d / (n + tag)),
                                        extra[-1], reads["a"], reads["b"]],
                lambda n: [str(d / (n + tag))])
    vals = dict(line.split("\t") for line in got[0].decode().splitlines())
    assert int(vals["sampledReads"]) > 0
    assert t_es.run(["--device", "cpu", "0", reads["a"]]) == 1


def test_owner_hash_np_equal():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**62, 50_000).astype(np.uint64)
    assert np.array_equal(t_es.owner_hash_np(keys), j_es.owner_hash_np(keys))
    wide = rng.integers(0, 256, (1000, 12), dtype=np.uint8).view("S12")[:, 0]
    assert np.array_equal(t_es.owner_hash_np(wide), j_es.owner_hash_np(wide))
    for d in (2, 8, 13):
        counts = np.bincount(t_es.owner_hash_np(keys) % np.uint32(d),
                             minlength=d)
        assert counts.min() > 0.9 * len(keys) / d
        assert counts.max() < 1.1 * len(keys) / d



@pytest.mark.parametrize("app", ["fastq2fasta", "randomly_sample"])
def test_host_apps_ignore_the_device(reads, tmp_path, app):
    """The host-only apps accept --device and run on the host whichever
    device is named, with or without a visible GPU: the same bytes as with
    no flag. A name that is no device is refused."""
    run, argv = {"fastq2fasta": (t_f2f.run, []),
                 "randomly_sample": (t_rs.run, ["--num-samples", "50"])}[app]
    got = []
    for i, dev in enumerate(([], ["--device", "cuda"], ["--device", "cpu"])):
        out = str(tmp_path / str(i))
        assert run(dev + argv + ["--out", out, reads["a"]]) == 0
        got.append([open(os.path.join(tmp_path, f), "rb").read()
                    for f in sorted(os.listdir(tmp_path))
                    if f.startswith(str(i))])
    assert got[0] and got[0][0] and got[0] == got[1] == got[2]
    with pytest.raises(ValueError, match="--device"):
        run(["--device", "tpu"] + argv + ["--out", str(tmp_path / "x"),
                                          reads["a"]])
