"""One time limit for every test of the repository: LIMIT seconds a phase.

A test that hangs would otherwise hold its pytest-xdist worker, and every
test queued behind it, until the whole run is cut. The JAX package's tests
start FilterReads subprocesses with no time limit of their own, and that
app's fork pool can hang at its end (ROADMAP fault 3f): its parent waits in
wait4 on a worker stuck in a futex wait.

Each phase of a test (setup, call, teardown) runs under a SIGALRM timer of
LIMIT seconds. When it fires, the handler writes the test's Python stack
and the command lines of the process's live descendants to stderr, kills
those descendants with SIGKILL (found by parent pid under /proc: a test's
children need not start sessions of their own, so a session kill would
miss them), and fails the test. The handler and the timer found before a
phase are put back after it. A test run outside the main thread has no
limit: only the main thread can take a signal handler.

The limit ends only a hang in which Python gets control back: the handler
runs between bytecodes, after a blocking call that the signal interrupts
returns (time.sleep, subprocess's wait4). A main thread stuck in native
code that retries its own waits, such as an in-process XLA futex wait or a
CUDA synchronize, never runs it, and holds its worker as before.

LIMIT is at least three times the longest test that passes (78.0 s,
tests/test_variant_purge_e2e.py, in a whole tier-1 run of 6 workers on 8
cores, which took 270 s), so three hung tests on one worker still end
well inside the run's 1,470 s.
"""
import contextlib
import os
import signal
import sys
import threading
import time
import traceback

import pytest

LIMIT = 300  # seconds a phase of a test


def _children() -> dict:
    """{parent pid: [child pids]} of every process /proc lists."""
    kids = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name, "rb") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name, in parentheses, may hold spaces: the state and
        # the parent pid follow its closing one
        ppid = int(stat[stat.rindex(b")") + 2:].split()[1])
        kids.setdefault(ppid, []).append(int(name))
    return kids


def _stop_descendants(root: int) -> list:
    """SIGSTOP every descendant of `root`, scanning again until a scan
    finds none new, so that none forks or is orphaned (and so lost from the
    tree) before the kill. Returns their pids, parents first."""
    found = []
    while True:
        kids, todo, new = _children(), [root], []
        while todo:
            for pid in kids.get(todo.pop(), ()):
                todo.append(pid)
                if pid not in found:
                    new.append(pid)
        if not new:
            return found
        for pid in new:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGSTOP)
        found += new


def _cmdline(pid: int) -> str:
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _expire(signum, frame):
    """The limit was reached: report, end the test's processes, fail."""
    sys.stderr.write("over the time limit of %d s; the test's stack:\n"
                     % LIMIT)
    traceback.print_stack(frame, file=sys.stderr)
    pids = _stop_descendants(os.getpid())
    for pid in pids:
        line = _cmdline(pid)
        if line:  # a zombie has no command line
            sys.stderr.write("killing descendant %d: %s\n" % (pid, line))
    for pid in pids:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    sys.stderr.flush()
    pytest.fail("over its time limit of %d s" % LIMIT, pytrace=False)


@contextlib.contextmanager
def time_limit():
    """Run the body under LIMIT seconds of ITIMER_REAL with `_expire` as
    the SIGALRM handler; then put back the handler and the timer found
    (the timer less the time the body took)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    old = signal.signal(signal.SIGALRM, _expire)
    left, interval = signal.setitimer(signal.ITIMER_REAL, LIMIT)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        if left > 0:
            # a timer that fell due meanwhile fires at once
            signal.setitimer(signal.ITIMER_REAL,
                             max(left - (time.monotonic() - start), 1e-6),
                             interval)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with time_limit():
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with time_limit():
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with time_limit():
        yield
