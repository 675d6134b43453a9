"""N ranks of one job of the port in gloo processes on the CPU, for the
port's multi-process tests.

Each rank is a fresh interpreter in a session of its own with one torch
thread (ONE_THREAD), under a time limit that ends every session of the
job: the host engine's pool workers hold the output pipes, so killing an
interpreter alone could leave the test waiting on them. A coordinator
port taken between the probe and the bind is retried on another."""
import os
import signal
import socket
import subprocess
import sys
import time

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def env(**extra):
    """The environment of a rank: the repo on the path, one thread, JAX
    (for the JAX app's ranks) on the CPU with one device a process."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("XLA_FLAGS", "PYTHONPATH")}
    e.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **ONE_THREAD, **extra)
    return e


def _kill(proc) -> None:
    """Ends the rank's whole session."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_ranks(argv, n: int, extra_env=None, cwd=None):
    """Runs argv(coordinator, rank), a command line, as ranks 0 to n - 1
    of one job; returns each rank's (stdout, stderr) in rank order. Raises
    with the ranks' errors when a rank fails or the job passes TIMEOUT."""
    for _ in range(3):
        coord = "127.0.0.1:%d" % free_port()
        procs = [subprocess.Popen(argv(coord, r), env=env(**(extra_env or {})),
                                  cwd=cwd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  start_new_session=True)
                 for r in range(n)]
        deadline = time.monotonic() + TIMEOUT
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            for p in procs:
                _kill(p)
            errs = [e for _, e in outs] + [p.communicate()[1]
                                           for p in procs[len(outs):]]
            raise AssertionError("no end in %d s:\n%s" % (
                TIMEOUT, "\n".join(e[-3000:] for e in errs)))
        finally:
            for p in procs:
                if p.poll() is None:
                    _kill(p)
        if all(p.returncode == 0 for p in procs):
            return outs
        if not any("ddress already in use" in e for _, e in outs):
            break
    raise AssertionError("\n".join("rank %d exited %s:\n%s" % (
        r, p.returncode, e[-3000:]) for r, (p, (_, e)) in
        enumerate(zip(procs, outs))))


def app_ranks(module: str, args, n: int, extra_env=None):
    """`python -m module args --distributed C --nprocs n --procid r` as
    the n ranks of one job (the port's app with --device cpu)."""
    dev = (["--device", "cpu"] if module.startswith("kmernator_tpu_torch.")
           else ["--jax-platform", "cpu"])
    return run_ranks(lambda coord, r: [
        sys.executable, "-m", module] + dev + list(args) + [
        "--distributed", coord, "--nprocs", str(n), "--procid", str(r)],
        n, extra_env)
