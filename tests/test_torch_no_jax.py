"""kmernator_tpu_torch never imports jax: a fresh interpreter imports every
module of the port and runs the CPU app on both --mesh 1 paths, then
checks that jax is not in sys.modules."""
import os
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
base = ["--device", "cpu", "--mesh", "1", "--min-read-length", "25"]
inp = os.path.join(d, "in.fastq")
assert run(base + ["--out", os.path.join(d, "m"), "31", inp]) == 0
assert run(base + ["--streaming", "--out", os.path.join(d, "s"), "31",
                   inp]) == 0
assert os.path.getsize(os.path.join(d, "m-MinDepth2-in.fastq")) > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
