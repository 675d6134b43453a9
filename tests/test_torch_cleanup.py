"""The port's cleanup registry across a fork (kmernator_tpu_torch/utils/
cleanup.py): a forked pool worker holds none of its parent's temporary
paths, keeps SIGTERM's default action, and so dies at once when
Pool.terminate signals it, deleting nothing of its parent's."""
import os
import subprocess
import sys

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a program of its own: register_path installs signal handlers in
# the process that calls it
SCRIPT = r"""
import multiprocessing as mp, os, signal, sys, tempfile, time
from kmernator_tpu_torch.utils import cleanup
parent_dir = tempfile.mkdtemp(dir=sys.argv[1])
cleanup.register_path(parent_dir)

def worker(q):
    q.put((signal.getsignal(signal.SIGTERM) is signal.SIG_DFL,
           len(cleanup._paths)))
    time.sleep(60)

ctx = mp.get_context("fork")
q = ctx.Queue()
p = ctx.Process(target=worker, args=(q,))
p.start()
default_action, n_paths = q.get(timeout=30)
p.terminate()
p.join(30)
print(default_action, n_paths, p.exitcode, os.path.isdir(parent_dir),
      signal.getsignal(signal.SIGTERM) is cleanup._handler)
"""


def test_forked_worker_dies_on_sigterm_and_keeps_parent_paths(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   **ONE_THREAD),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    default_action, n_paths, exitcode, kept, parent_handler = \
        proc.stdout.split()
    assert default_action == "True" and n_paths == "0"
    assert exitcode == "-15"
    assert kept == "True"            # the worker deleted nothing
    assert parent_handler == "True"  # the parent still cleans up on SIGTERM
