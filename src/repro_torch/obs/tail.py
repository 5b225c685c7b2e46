"""Robust tail/follow reader for live JSONL telemetry streams.

The operator console must read a stream that is being *written right
now* by a training run (``TelemetryRecorder`` with a live sink flushes
one line per record), so the reader has to survive everything a live
file does:

  - **partial trailing lines** — a record flushed halfway stays in the
    buffer until its newline arrives; nothing half-parsed is ever
    yielded;
  - **truncation** — the file shrinking below the read position (a rerun
    over the same path) restarts the reader from offset 0;
  - **rotation** — the path pointing at a new inode (rename + recreate)
    reopens the new file from the start;
  - **the file not existing yet** — follow mode waits for it to appear.

No dependencies beyond the standard library; decoding into telemetry
records is the ``repro_torch.telemetry.schema.StreamDecoder``'s job (which is
where unknown-kind / newer-schema tolerance lives).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterator, List, Optional


class TailReader:
    """Incremental line reader over one path. ``read_available()`` returns
    every complete line that appeared since the last call; ``follow()``
    polls forever (until ``stop`` fires). Bytes after the last newline
    are buffered, not yielded."""

    def __init__(self, path: str, poll: float = 0.2):
        self.path = path
        self.poll = poll
        self._f = None
        self._ino: Optional[int] = None
        self._pos = 0
        self._buf = b""

    # ------------------------------------------------------------ plumbing
    def _close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        self._ino = None
        self._pos = 0
        self._buf = b""

    def _reopen(self) -> bool:
        self._close()
        try:
            self._f = open(self.path, "rb")
        except FileNotFoundError:
            return False
        self._ino = os.fstat(self._f.fileno()).st_ino
        return True

    def _check_rotation(self):
        """Reopen on inode change (rotation) or shrink (truncation)."""
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            self._close()                        # wait for it to reappear
            return
        if self._f is None or st.st_ino != self._ino:
            self._reopen()
        elif st.st_size < self._pos:
            self._f.seek(0)
            self._pos = 0
            self._buf = b""

    # ------------------------------------------------------------- reading
    def read_available(self) -> List[str]:
        """Every complete line that is new since the last call."""
        self._check_rotation()
        if self._f is None:
            return []
        chunk = self._f.read()
        if not chunk:
            return []
        self._pos += len(chunk)
        self._buf += chunk
        if b"\n" not in self._buf:
            return []
        complete, self._buf = self._buf.rsplit(b"\n", 1)
        return [ln.decode("utf-8", errors="replace")
                for ln in complete.split(b"\n")]

    def follow(self, stop: Optional[Callable[[], bool]] = None
               ) -> Iterator[str]:
        """Yield lines forever, polling every ``poll`` seconds. ``stop``
        is checked between polls; one final drain runs after it fires so
        a writer that finished just before is fully consumed."""
        while True:
            lines = self.read_available()
            for ln in lines:
                yield ln
            if stop is not None and stop():
                for ln in self.read_available():
                    yield ln
                return
            if not lines:
                time.sleep(self.poll)

    def close(self):
        self._close()


def read_complete_lines(path: str) -> List[str]:
    """One-shot read of every complete line (``--once`` mode); a partial
    trailing line is dropped, exactly like the follow reader would hold
    it back."""
    r = TailReader(path)
    try:
        return r.read_available()
    finally:
        r.close()
