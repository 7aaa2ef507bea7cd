"""Run logging with pre-start buffering and warn-once dedup.

Equivalent of the reference's EasyLog (easylog.h:25-146):
log lines are buffered until an output directory is chosen, warnings are
deduplicated and re-issued at end of run.
"""

import io
import sys


class EasyLog:
    def __init__(self):
        self._buffer = io.StringIO()
        self._stream = None  # falls back to buffer until started
        self._warn_once = {}
        self._echo = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, stream, echo=False):
        """Attach to a real stream; flush anything buffered so far."""
        self._stream = stream
        self._echo = echo
        buffered = self._buffer.getvalue()
        if buffered:
            self._stream.write(buffered)
        self._buffer = io.StringIO()

    @property
    def started(self):
        return self._stream is not None

    def log(self, msg):
        line = msg if msg.endswith("\n") else msg + "\n"
        (self._stream or self._buffer).write(line)
        if self._echo and self._stream not in (sys.stdout, sys.stderr):
            sys.stderr.write(line)

    def warn(self, msg):
        self.log("WARNING: " + msg)

    def warn_once(self, msg):
        if msg not in self._warn_once:
            self._warn_once[msg] = 1
            self.log("WARNING ONCE: " + msg)
        else:
            self._warn_once[msg] += 1

    def reissue_warnings(self):
        if self._warn_once:
            self.log("Summary of warnings (count x message):")
            for msg, n in self._warn_once.items():
                self.log(f"  {n} x {msg}")

    def contents(self):
        if self._stream is not None and hasattr(self._stream, "getvalue"):
            return self._stream.getvalue()
        return self._buffer.getvalue()
