"""Leveled logging with per-process identity.

Mirrors the reference's Log/Logger level system (ref: src/Log.h:79-486):
Verbose/Debug/Warn/Error levels with per-rank stamps; messages go to
stderr.

Copied for kmernator_tpu_torch from kmernator_tpu/utils/logging.py. It
differs from its source in its package imports and in `flush_gathered`,
which lacks the source's multi-process gather over jax: the port runs one
process, so the buffered lines are emitted as they are (its FilterReads
refuses --gathered-logs).
"""
from __future__ import annotations

import os
import sys
import time

_t0 = time.time()


class Log:
    verbose_level = 0
    debug_level = 0
    _file = None
    gathered = False
    _buffer: list = []

    @classmethod
    def set_log_file(cls, path: str):
        """--log-file: tee all messages to a file (ref: Options.h log-file)."""
        cls._file = open(path, "a") if path else None

    @classmethod
    def _emit(cls, line: str, force: bool = False):
        if cls.gathered and not force:
            cls._buffer.append(line)
            return
        print(line, file=sys.stderr, flush=True)
        if cls._file is not None:
            cls._file.write(line + "\n")
            cls._file.flush()

    @classmethod
    def flush_gathered(cls):
        """--gathered-logs: collect every process's buffered log lines and
        emit them rank-ordered from process 0 only (ref: src/Log.h:79
        gathered output to master, enabled by Options.h:382).  Collective —
        every process must call it at the same point."""
        if not cls.gathered:
            return
        blob = "\n".join(cls._buffer).encode()
        cls._buffer = []
        for line in blob.decode().split("\n"):
            if line:
                cls._emit(line, force=True)

    @staticmethod
    def _stamp() -> str:
        rank = os.environ.get("KMERNATOR_TPU_RANK", "0")
        return "%s %7.2f [%s]" % (time.strftime("%Y-%m-%d %H:%M:%S"), time.time() - _t0, rank)

    @classmethod
    def is_verbose(cls, level: int) -> bool:
        return cls.verbose_level >= level

    @classmethod
    def is_debug(cls, level: int) -> bool:
        return cls.debug_level >= level

    @classmethod
    def verbose(cls, level: int, msg: str):
        if cls.verbose_level >= level:
            cls._emit("%s VERBOSE: %s" % (cls._stamp(), msg))

    @classmethod
    def debug(cls, level: int, msg: str):
        if cls.debug_level >= level:
            cls._emit("%s DEBUG: %s" % (cls._stamp(), msg))

    @classmethod
    def warn(cls, msg: str):
        cls._emit("%s WARN: %s" % (cls._stamp(), msg))

    @classmethod
    def error(cls, msg: str):
        # errors always print immediately on their own rank, even when
        # logs are gathered (ref: LOG_ERROR is never deferred)
        cls._emit("%s ERROR: %s" % (cls._stamp(), msg), force=True)
