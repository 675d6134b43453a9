"""The port's ReadSet.identify_pairs (kmernator_tpu_torch/io/reads.py, the
sequential pass and the name matching as array passes) against the JAX
package's (the reference's loop over the reads the sequential pass
leaves): the same pairs list, entry for entry, on each family of names."""
import numpy as np
import pytest

from kmernator_tpu.io.reads import ReadSet as JaxReadSet
from kmernator_tpu_torch.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.io.reads import ReadSet, parse_fastq_bytes

import torch_threads  # noqa: F401  (one torch thread in this process)

SUFFIXES = [b"/1", b"/2", b"/A", b"/B", b"/F", b"/R", b""]
CASAVAS = [b"1:N:0:AC", b"2:N:0:AC", b"1:Y:0:", b"2:Y:18:GG", b""]


def _adversarial(rng):
    """tests/test_readset.py's generator: suffixes, CASAVA comments, names
    of length 0-2 and `a/`."""
    names, comments = [], []
    for _ in range(int(rng.integers(0, 40))):
        base = b"rd%d" % rng.integers(0, 8)
        style = rng.integers(0, 4)
        if style == 0:
            names.append(base + SUFFIXES[rng.integers(0, len(SUFFIXES))])
            comments.append(b"")
        elif style == 1:
            names.append(base)
            comments.append(CASAVAS[rng.integers(0, len(CASAVAS))])
        elif style == 2:
            names.append([b"", b"a", b"/1", b"ab", b"a/"][rng.integers(0, 5)])
            comments.append(b"")
        else:
            names.append(base + SUFFIXES[rng.integers(0, len(SUFFIXES))])
            comments.append(CASAVAS[rng.integers(0, len(CASAVAS))])
    return names, comments


def _groups(rng):
    """Groups of 3-7 reads sharing a name (`/1 /1 /2`, `/2 /1`, ...),
    with reads of read number 0 between them, in a shuffled order."""
    names = []
    for g in range(int(rng.integers(1, 12))):
        names += [b"grp%d/%s" % (g, b"12"[rng.integers(0, 2):][:1])
                  for _ in range(int(rng.integers(3, 8)))]
        names += [b"grp%d" % g, b"grp%d/X" % g][:int(rng.integers(0, 3))]
    names = [names[i] for i in rng.permutation(len(names))]
    return names, [b""] * len(names)


def _nul(rng):
    """Names that hold NUL bytes, inside and at the end, with CASAVA
    comments so that they carry read numbers."""
    pool = [b"a\0b", b"a\0c", b"ab/1\0", b"ab/2", b"ab/", b"x\0/1",
            b"x\0/2", b"q\0\0", b"q\0"]
    names = [pool[i] for i in rng.integers(0, len(pool), 30)]
    comments = [CASAVAS[i] for i in rng.integers(0, len(CASAVAS), 30)]
    return names, comments


def _two_files(rng):
    """A two-file mate split: all /1 reads, then the /2 mates of most of
    them, in the same order."""
    n = int(rng.integers(1, 60))
    mates = [i for i in range(n) if rng.random() < 0.8]
    names = [b"r%d/1" % i for i in range(n)] + [b"r%d/2" % i for i in mates]
    return names, [b""] * len(names)


def _interleaved(rng):
    """Interleaved true pairs: the sequential pass pairs every read."""
    n = int(rng.integers(1, 60))
    names = [b"p%d/%d" % (i, m) for i in range(n) for m in (1, 2)]
    return names, [b""] * len(names)


def _readset(cls, names, comments):
    rs = cls()
    n = len(names)
    rs.append_arrays(list(names), list(comments),
                     np.full(n, ord("A"), np.uint8),
                     np.full(n, 70, np.uint8),
                     np.arange(n + 1, dtype=np.int64), np.ones(n, bool))
    return rs


def _pairs(names, comments):
    """Both packages' pairs lists of one name set."""
    port = _readset(ReadSet, names, comments)
    ref = _readset(JaxReadSet, names, comments)
    assert port.identify_pairs() == ref.identify_pairs()
    assert all(type(a) is int and type(b) is int for a, b in port.pairs)
    return port.pairs, ref.pairs


@pytest.mark.parametrize("family, sets", [
    ("adversarial", 300), ("groups", 100), ("nul", 100),
    ("two_files", 50), ("interleaved", 20)])
def test_same_pairs_as_the_jax_package(family, sets):
    make = {"adversarial": _adversarial, "groups": _groups, "nul": _nul,
            "two_files": _two_files, "interleaved": _interleaved}[family]
    rng = np.random.default_rng(23)
    for trial in range(sets):
        names, comments = make(rng)
        port, ref = _pairs(names, comments)
        assert port == ref, (family, trial, names, comments)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_same_pairs_on_tiny_sets(n):
    """Every name set of n reads over a small alphabet."""
    alphabet = [(b"a/1", b""), (b"a/2", b""), (b"a", b""), (b"b/1", b""),
                (b"a", b"2:N:0:AC"), (b"", b"")]
    for idx in np.ndindex(*([len(alphabet)] * n)):
        names = [alphabet[i][0] for i in idx]
        comments = [alphabet[i][1] for i in idx]
        port, ref = _pairs(names, comments)
        assert port == ref, (names, comments)


def test_same_pairs_on_a_metagenome_chunk(tmp_path):
    """A generated metagenome's reads, whose names all end in /1: the
    sequential pass pairs nothing and the name matching takes every
    read, each its own entry."""
    path = str(tmp_path / "in.fastq")
    assert generate(["--genomes", "2", "--total-genome-mb", "0.02",
                     "--coverage", "20", "--seed", "11", "--out",
                     path]) == 0
    with open(path, "rb") as f:
        names, comments = parse_fastq_bytes(f.read())[:2]
    assert len(names) > 2000 and all(nm.endswith(b"/1") for nm in names)
    port, ref = _pairs(names, comments)
    assert port == ref == [(i, -1) for i in range(len(names))]
