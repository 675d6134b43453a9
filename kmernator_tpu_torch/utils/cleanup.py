"""Signal-driven cleanup of temporary artifacts.

The reference installs signal handlers that tear down temp dirs/fifos and
log a stack trace on fatal signals (ref: src/Utils.h:1288-1410 Cleanup).
Here: a process-global registry of paths + callbacks, flushed on SIGINT/
SIGTERM and at interpreter exit.

Copied for kmernator_tpu_torch from kmernator_tpu/utils/cleanup.py. It
differs from its source in its package imports and in `_forget_in_child`:
a forked child (a pool worker) starts with an empty registry, with
SIGINT/SIGTERM back at their default action, and never installs the
handlers. In the source a worker inherits the parent's Python-level
handler, so a SIGTERM from `Pool.terminate` deletes the parent's
temporary files, and one that lands just before the worker blocks on the
pool's queue lock is never handled: the worker sleeps on a lock its killed
sibling held, and the parent's `terminate` joins it for ever.
"""
from __future__ import annotations

import atexit
import os
import shutil
import signal
import sys
from typing import Callable, List

from kmernator_tpu_torch.utils.logging import Log

_paths: List[str] = []
_callbacks: List[Callable[[], None]] = []
_installed = False


def register_path(path: str):
    """Delete `path` (file, fifo, or directory tree) on exit/signal."""
    _install()
    _paths.append(path)


def register_callback(fn: Callable[[], None]):
    _install()
    _callbacks.append(fn)


def unregister_path(path: str):
    try:
        _paths.remove(path)
    except ValueError:
        pass


def _flush():
    while _callbacks:
        try:
            _callbacks.pop()()
        except Exception:
            pass
    while _paths:
        p = _paths.pop()
        try:
            if os.path.isdir(p) and not os.path.islink(p):
                shutil.rmtree(p, ignore_errors=True)
            elif os.path.exists(p):
                os.unlink(p)
        except OSError:
            pass


def _handler(signum, frame):
    Log.warn("caught signal %d — cleaning up temporary files" % signum)
    _flush()
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _forget_in_child():
    """After a fork, in the child: the parent's paths and callbacks are not
    the child's to delete, and the child never installs the handlers, so it
    dies on SIGINT/SIGTERM at once. Paths the child registers (a worker's
    share of its parent's spill directory) are flushed only if it exits
    through the interpreter, never by a signal."""
    global _installed
    _paths.clear()
    _callbacks.clear()
    _installed = True
    for sig in (signal.SIGINT, signal.SIGTERM):
        if signal.getsignal(sig) is _handler:
            signal.signal(sig, signal.SIG_DFL)


os.register_at_fork(after_in_child=_forget_in_child)


def _install():
    global _installed
    if _installed:
        return
    _installed = True
    atexit.register(_flush)
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old = signal.getsignal(sig)
            if old in (signal.SIG_DFL, signal.default_int_handler):
                signal.signal(sig, _handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
