"""Named pipes that serve in-memory text to the program, as the shell's
process substitution `<(zcat reads.fq.gz)` serves yak: each job reads
a path that is a pipe, written by a thread of this process, so the
inputs never touch the disk and two pipes are two distinct streams.
"""

import errno
import fcntl
import os
import threading

CHUNK = 1 << 20
WAIT_S = 10.0           # for the writer, once the job has returned
F_SETPIPE_SZ = 1031     # fcntl.F_SETPIPE_SZ (Linux), absent before 3.10


def make_pipe(path):
    if os.path.exists(path):
        os.unlink(path)
    os.mkfifo(path)
    return path


class Feed:
    """Write `data` (bytes-like) into the named pipe `path` from a thread
    while the block runs; the thread opens the pipe when a reader does.
    On leaving, the writer is waited for; if the reader never came or
    left early, the pipe is opened and closed for reading so that the
    writer ends (it then sees a broken pipe)."""

    def __init__(self, path, data):
        self.path = path
        self.data = memoryview(data).cast("B")
        self.error = None
        self.written = 0
        self._thread = threading.Thread(target=self._write, daemon=True)

    def _write(self):
        try:
            fd = os.open(self.path, os.O_WRONLY)
        except OSError as e:
            self.error = e
            return
        try:
            try:
                fcntl.fcntl(fd, F_SETPIPE_SZ, CHUNK)
            except OSError:
                pass            # a smaller pipe only costs more switches
            while self.written < len(self.data):
                self.written += os.write(
                    fd, self.data[self.written:self.written + CHUNK])
        except BrokenPipeError:
            pass                # the reader stopped early; so does this
        except OSError as e:
            self.error = e
        finally:
            os.close(fd)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._thread.join(timeout=WAIT_S if exc[0] is None else 0.5)
        for _ in range(20):
            if not self._thread.is_alive():
                break
            try:        # no reader: be one, so the writer's open returns
                os.close(os.open(self.path, os.O_RDONLY | os.O_NONBLOCK))
            except OSError as e:
                if e.errno != errno.ENXIO:
                    raise
            self._thread.join(timeout=0.5)
        if exc[0] is None:
            if self.error is not None:
                raise self.error
            if self.written < len(self.data):
                raise RuntimeError(f"{self.path}: the program read "
                                   f"{self.written} of {len(self.data)} "
                                   f"bytes")
        return False
