"""The suite's one time limit (the repository's root conftest.py).

A copy of the root conftest with LIMIT lowered to 2 s runs three tests in a
pytest subprocess: one that sleeps, one whose child waits on a forked
grandchild that sleeps (the shape of a fork pool that hangs at its end), and
one that passes. The first two must fail at the limit with its message and
leave no process behind; the third must pass. A second test holds the
limit's context manager to putting back the SIGALRM handler and timer it
found.
"""
import importlib.util
import os
import signal
import subprocess
import sys
import time
import uuid
import xml.etree.ElementTree as ET

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFTEST = os.path.join(REPO, "conftest.py")

HUNG_TESTS = '''
import os
import subprocess
import sys
import time

MARK = {mark!r}


def test_sleeps():
    time.sleep(60)


def test_grandchild_blocks():
    code = ("import os, time\\n"
            "pid = os.fork()\\n"
            "if pid == 0:\\n"
            "    time.sleep(60)\\n"
            "    os._exit(0)\\n"
            "os.waitpid(pid, 0)\\n")
    subprocess.run([sys.executable, "-c", code, MARK])


def test_passes():
    assert True
'''


def _processes_with(mark: str) -> list:
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/cmdline" % name, "rb") as f:
                if mark.encode() in f.read():
                    found.append(int(name))
        except OSError:
            pass
    return found


def test_hung_tests_fail_at_the_limit_and_leave_no_process(tmp_path):
    with open(CONFTEST) as f:
        text = f.read()
    assert text.count("\nLIMIT = 300 ") == 1
    (tmp_path / "conftest.py").write_text(
        text.replace("\nLIMIT = 300 ", "\nLIMIT = 2 "))
    (tmp_path / "pyproject.toml").write_text("[tool.pytest.ini_options]\n")
    mark = "kmtpu-time-limit-%s" % uuid.uuid4().hex
    (tmp_path / "test_hung.py").write_text(HUNG_TESTS.format(mark=mark))
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-q",
         "--junitxml", str(tmp_path / "out.xml"), str(tmp_path)],
        cwd=str(tmp_path), env=dict(os.environ, **ONE_THREAD),
        capture_output=True, text=True, timeout=120)
    took = time.monotonic() - start
    assert took < 30, (took, proc.stdout[-2000:])
    cases = {c.get("name"): c for c in
             ET.parse(str(tmp_path / "out.xml")).getroot().iter("testcase")}
    assert set(cases) == {"test_sleeps", "test_grandchild_blocks",
                          "test_passes"}, proc.stdout[-2000:]
    for name in ("test_sleeps", "test_grandchild_blocks"):
        failure = cases[name].find("failure")
        assert failure is not None, (name, proc.stdout[-2000:])
        assert failure.get("message").endswith(
            "over its time limit of 2 s"), failure.get("message")
    assert len(cases["test_passes"]) == 0, proc.stdout[-2000:]
    # the handler named the processes it killed, the child and grandchild
    assert proc.stdout.count("killing descendant") >= 2, proc.stdout[-2000:]
    assert proc.returncode == 1
    assert _processes_with(mark) == []


def _load_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest_copy",
                                                  CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_time_limit_puts_back_the_handler_and_timer_it_found():
    mod = _load_conftest()

    def own(signum, frame):
        raise AssertionError("the test's own timer fired")

    outer = signal.signal(signal.SIGALRM, own)
    outer_timer = signal.setitimer(signal.ITIMER_REAL, 50)
    try:
        # the repository's limit is armed around this test too
        assert outer.__name__ == "_expire" and 0 < outer_timer[0] <= 300
        with mod.time_limit():
            assert signal.getsignal(signal.SIGALRM) is mod._expire
            assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= mod.LIMIT
            time.sleep(0.2)
        assert signal.getsignal(signal.SIGALRM) is own
        left = signal.getitimer(signal.ITIMER_REAL)[0]
        # the test's timer, less the time the body took
        assert 45 < left < 49.9
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer)
        signal.setitimer(signal.ITIMER_REAL, *outer_timer)
