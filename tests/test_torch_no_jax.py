"""kmernator_tpu_torch imports neither jax nor the JAX package: a fresh
interpreter imports every module of the port and runs the port's
FilterReads CLI on its three engines (host, --mesh 1, --streaming --mesh
1) on the CPU, the in-memory --mesh 1 with the on-device variant purge,
both --mesh 1 paths at k = 33, the `--streaming --distributed X --nprocs
1` engine, both --mesh paths at --mesh 2, the MeraculousCounter CLI on
its three engines (host, --streaming, --mesh 1) and at --mesh 2, the
nucleating assembler on its three matchers (host, --kmer-size 0, --mesh
1) and at --mesh 2, and the contig extender (and, in a second interpreter, the small apps: fastq2fasta,
randomly_sample, split_sequence, compare_spectrums, estimate_size,
tnf_distance, bam_sort with SAM and BAM output, filter_and_sort_sam),
then checks that no module named jax, kmernator_tpu or kmernator_tpu.* was
loaded; so do two gloo ranks of FilterReads at --nprocs 2, in memory and
with --streaming --distributed. And no source file of the port names the
JAX package in an import, lazy ones inside functions included."""
import os
import re
import signal
import subprocess
import sys

import numpy as np

from torch_ranks import run_ranks
from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROLOGUE = r"""
import os, pkgutil, sys, importlib
import numpy as np
import kmernator_tpu_torch
for m in pkgutil.walk_packages(kmernator_tpu_torch.__path__,
                               "kmernator_tpu_torch."):
    importlib.import_module(m.name)
from kmernator_tpu_torch.apps.filter_reads import run
d = sys.argv[1]
rng = np.random.default_rng(3)
acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
genome = rng.integers(0, 4, 4000, dtype=np.uint8)
with open(os.path.join(d, "in.fastq"), "wb") as f:
    for i in range(200):
        s = int(rng.integers(0, 4000 - 72))
        f.write(b"@r%03d\n%s\n+\n%s\n"
                % (i, acgt[genome[s:s + 72]].tobytes(), b"H" * 72))
inp = os.path.join(d, "in.fastq")
"""

ENGINES = r"""
base = ["--device", "cpu", "--min-read-length", "25"]
for name, extra, k in (
        ("h", [], "31"), ("m", ["--mesh", "1"], "31"),
        ("s", ["--streaming", "--mesh", "1"], "31"),
        ("v", ["--mesh", "1", "--variant-sigmas", "2",
               "--min-variant-kmer-depth", "3"], "31"),
        ("w", ["--mesh", "1"], "33"),
        ("x", ["--streaming", "--mesh", "1"], "33"),
        ("d", ["--streaming", "--streaming-chunk-mb", "0.005",
               "--distributed", "127.0.0.1:1", "--nprocs", "1",
               "--mesh-batch", "32"], "31"),
        ("m2", ["--mesh", "2"], "31"),
        ("s2", ["--streaming", "--mesh", "2"], "31")):
    assert run(base + extra + ["--out", os.path.join(d, name), k,
                               inp]) == 0
    assert os.path.getsize(os.path.join(d, name + "-MinDepth2-in.fastq")) > 0
from kmernator_tpu_torch.apps.meraculous_counter import run as mer_run
for name, extra in (("mh", []), ("ms", ["--streaming"]),
                    ("mm", ["--mesh", "1"]), ("mm2", ["--mesh", "2"])):
    assert mer_run(["--device", "cpu"] + extra + [
        "--kmer-size", "21", "--out", os.path.join(d, name), inp]) == 0
    for suffix in (".mercount.m21", ".mergraph.m21.D2"):
        assert os.path.getsize(os.path.join(d, name + suffix)) > 0
from kmernator_tpu_torch.apps.nucleating_assembler import run as asm_run
from kmernator_tpu_torch.apps.contig_extender import run as ext_run
seeds = os.path.join(d, "seeds.fa")
with open(seeds, "wb") as f:
    for i in (5, 50):
        f.write(b">s%d\n%s\n" % (i, acgt[genome[100 * i:100 * i + 60]]
                                   .tobytes()))
for name, extra, k in (("ah", [], "21"), ("av", [], "0"),
                       ("am", ["--mesh", "1"], "21"),
                       ("am2", ["--mesh", "2"], "21")):
    out = os.path.join(d, name + ".fa")
    assert asm_run(["--device", "cpu", "--contig-file", seeds,
                    "--max-iterations", "2", "--out", out] + extra
                   + [k, inp]) == 0
    assert open(out, "rb").read().count(b">") == 2
out = os.path.join(d, "ext.fa")
assert ext_run(["--device", "cpu", "--contig-file", seeds, "--out", out,
                "21", inp]) == 0
assert open(out, "rb").read().count(b">") == 2
"""

SMALL_APPS = r"""
from kmernator_tpu_torch.apps import (bam_sort, compare_spectrums,
                                     estimate_size, fastq2fasta,
                                     filter_and_sort_sam, randomly_sample,
                                     split_sequence, tnf_distance)
cpu = ["--device", "cpu"]
p = lambda name: os.path.join(d, name)
assert fastq2fasta.run(cpu + ["--out", p("f2f"), inp]) == 0
assert randomly_sample.run(cpu + ["--num-samples", "5", "--out", p("rs.fq"),
                                  inp]) == 0
assert split_sequence.run(cpu + ["--num-files", "2", "--file-num", "1",
                                 "--out", p("ss.fq"), inp]) == 0
assert compare_spectrums.run(cpu + ["--out", p("cs"), "21", inp, inp]) == 0
assert estimate_size.run(cpu + ["--sample-partitions", "3", "--out",
                                p("es"), "21", inp]) == 0
assert tnf_distance.run(cpu + ["--inter-distance-file", p("tnf.inter"),
                               "--cluster-file", p("tnf.cl"), "--out",
                               p("tnf.vec"), inp]) == 0
sam = p("in.sam")
with open(sam, "w") as f:
    f.write("@SQ\tSN:g\tLN:4000\n")
    for i in range(20):
        f.write("q%d\t%d\tg\t%d\t%d\t72M\t=\t1\t0\t%s\t%s\n" % (
            i, 4 * (i % 3 == 0) | 16 * (i % 2), 1 + 150 * (19 - i), 3 * i,
            acgt[genome[:72]].tobytes().decode(), "I" * 72))
assert bam_sort.run(cpu + ["--unmapped-reads", p("un.fq.gz"),
                           p("sorted.bam"), sam]) == 0
assert bam_sort.run(cpu + [p("sorted.sam"), p("sorted.bam")]) == 0
assert filter_and_sort_sam.run(cpu + ["--min-mapq", "20", p("fs.bam"),
                                      sam]) == 0
for name in ("f2f-in.fasta", "rs.fq", "ss.fq", "cs", "es", "tnf.inter",
             "tnf.cl", "tnf.vec", "sorted.bam", "sorted.sam", "fs.bam"):
    assert os.path.getsize(p(name)) > 0, name
"""

EPILOGUE = r"""
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "kmernator_tpu"))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""

# an import of the JAX package or of jax, at any indentation
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import\s+kmernator_tpu\b(?!_)|from\s+kmernator_tpu(\.|\s+import)"
    r"|(import|from)\s+jax\b)", re.M)


def _run_clean(script, tmp_path):
    """Runs the script in a fresh interpreter of its own session, under a
    time limit that ends the whole session: the host engine's pool
    workers hold the output pipes, so killing the interpreter alone could
    leave the test waiting on them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, **ONE_THREAD)
    proc = subprocess.Popen([sys.executable, "-c", PROLOGUE + script
                             + EPILOGUE, str(tmp_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError("no end in 240 s:\n" + err[-3000:])
    assert proc.returncode == 0, out + err
    assert "JAX_MODULES []" in out


def test_port_never_imports_jax(tmp_path):
    _run_clean(ENGINES, tmp_path)


def test_small_apps_never_import_jax(tmp_path):
    _run_clean(SMALL_APPS, tmp_path)


RANK = r"""
import sys
from kmernator_tpu_torch.apps.filter_reads import run
coord, rank, d, extra = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
assert run(["--device", "cpu", "--min-read-length", "25", "--distributed",
            coord, "--nprocs", "2", "--procid", rank] + extra
           + ["--out", d + "/n", "31", d + "/in.fastq"]) == 0
"""


def test_nprocs_ranks_never_import_jax(tmp_path):
    """Two gloo ranks of the port's FilterReads, in memory and with
    --streaming --distributed: neither rank loads jax or the JAX
    package."""
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    with open(tmp_path / "in.fastq", "wb") as f:
        for i in range(400):
            s = int(rng.integers(0, 4000 - 72))
            f.write(b"@r%03d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s:s + 72]].tobytes(), b"H" * 72))
    for extra in ([], ["--streaming", "--streaming-chunk-mb", "0.005",
                       "--mesh-batch", "32"]):
        outs = run_ranks(lambda coord, r: [
            sys.executable, "-c", RANK + EPILOGUE, coord, str(r),
            str(tmp_path)] + extra, 2)
        assert all("JAX_MODULES []" in out for out, _ in outs), outs
        assert os.path.getsize(tmp_path / "n-MinDepth2-in.fastq") > 0


def test_no_source_imports_the_jax_package():
    sources = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                                 "design_probe.py")]
    for root, _, files in os.walk(os.path.join(REPO, "kmernator_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 20
    for new in ("apps/meraculous_counter.py", "ops/extensions.py",
                "parallel/mesh.py", "apps/nucleating_assembler.py",
                "apps/contig_extender.py", "parallel/dist_match.py",
                "ops/align.py", "ops/extend.py", "ops/match.py",
                "ops/vmatch.py", "ops/external.py", "utils/timers.py",
                "parallel/multihost.py", "io/bam.py", "apps/bam_sort.py",
                "apps/filter_and_sort_sam.py", "parallel/bam_exchange.py",
                "apps/fastq2fasta.py", "apps/randomly_sample.py",
                "apps/split_sequence.py", "apps/compare_spectrums.py",
                "apps/estimate_size.py", "apps/tnf_distance.py"):
        assert os.path.join(REPO, "kmernator_tpu_torch", new) in sources
    found = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        found += ["%s: %s" % (os.path.relpath(path, REPO), m.group(0).strip())
                  for m in JAX_PACKAGE_IMPORT.finditer(text)]
    assert not found, found
    # the pattern does catch what it is there to catch
    for line in ("import kmernator_tpu.io.reads", "    from kmernator_tpu."
                 "ops import kmer", "from kmernator_tpu import apps",
                 "        import jax", "from jax import numpy"):
        assert JAX_PACKAGE_IMPORT.search(line), line
    assert not JAX_PACKAGE_IMPORT.search("from kmernator_tpu_torch.ops "
                                         "import kmer")
