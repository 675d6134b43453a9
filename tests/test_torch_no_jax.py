"""kmernator_tpu_torch imports neither jax nor the JAX package: a fresh
interpreter imports every module of the port and runs the port's
FilterReads CLI on its three engines (host, --mesh 1, --streaming --mesh
1) on the CPU, the in-memory --mesh 1 with the on-device variant purge,
both --mesh 1 paths at k = 33, the `--streaming --distributed X --nprocs
1` engine, the MeraculousCounter CLI on its
three engines (host, --streaming, --mesh 1), the nucleating assembler on
its three matchers (host, --kmer-size 0, --mesh 1) and the contig
extender, then
checks that no module named jax, kmernator_tpu or kmernator_tpu.* was
loaded. And no source file of the port names the JAX package in an
import, lazy ones inside functions included."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
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
base = ["--device", "cpu", "--min-read-length", "25"]
inp = os.path.join(d, "in.fastq")
for name, extra, k in (
        ("h", [], "31"), ("m", ["--mesh", "1"], "31"),
        ("s", ["--streaming", "--mesh", "1"], "31"),
        ("v", ["--mesh", "1", "--variant-sigmas", "2",
               "--min-variant-kmer-depth", "3"], "31"),
        ("w", ["--mesh", "1"], "33"),
        ("x", ["--streaming", "--mesh", "1"], "33"),
        ("d", ["--streaming", "--streaming-chunk-mb", "0.005",
               "--distributed", "127.0.0.1:1", "--nprocs", "1",
               "--mesh-batch", "32"], "31")):
    assert run(base + extra + ["--out", os.path.join(d, name), k,
                               inp]) == 0
    assert os.path.getsize(os.path.join(d, name + "-MinDepth2-in.fastq")) > 0
from kmernator_tpu_torch.apps.meraculous_counter import run as mer_run
for name, extra in (("mh", []), ("ms", ["--streaming"]),
                    ("mm", ["--mesh", "1"])):
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
                       ("am", ["--mesh", "1"], "21")):
    out = os.path.join(d, name + ".fa")
    assert asm_run(["--device", "cpu", "--contig-file", seeds,
                    "--max-iterations", "2", "--out", out] + extra
                   + [k, inp]) == 0
    assert open(out, "rb").read().count(b">") == 2
out = os.path.join(d, "ext.fa")
assert ext_run(["--device", "cpu", "--contig-file", seeds, "--out", out,
                "21", inp]) == 0
assert open(out, "rb").read().count(b">") == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "kmernator_tpu"))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""

# an import of the JAX package or of jax, at any indentation
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import\s+kmernator_tpu\b(?!_)|from\s+kmernator_tpu(\.|\s+import)"
    r"|(import|from)\s+jax\b)", re.M)


def test_port_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


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
                "parallel/multihost.py"):
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
