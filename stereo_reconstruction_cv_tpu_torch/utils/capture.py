"""Stdout capture (a copy of ``stereo_reconstruction_cv_tpu/utils/capture.py``).

A context manager that tees stdout into a buffer, and by default still to
the terminal, so that API callers can collect the stages' printed logs; the
restore runs on every exit path.
"""

from __future__ import annotations

import contextlib
import io
import sys
from typing import Iterator


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def capture_stdout(echo: bool = True) -> Iterator[io.StringIO]:
    """Capture prints into a StringIO; optionally still echo to the tty."""
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = _Tee(buf, old) if echo else buf
    try:
        yield buf
    finally:
        sys.stdout = old
