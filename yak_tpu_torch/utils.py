"""Progress lines in the reference's `[M::func::real*cpu]` shape
(count.c:140-141, sys.c)."""

import sys
import time


class Progress:
    """Reference-shaped per-chunk progress lines:
    `[M::<name>::<real>*<cpu/real>] <message>` (count.c:140-141)."""

    def __init__(self, name):
        self.name = name
        self.t0 = time.time()
        self.c0 = time.process_time()

    def line(self, msg):
        rt = time.time() - self.t0
        cpu = time.process_time() - self.c0
        print(f"[M::{self.name}::{rt:.3f}*{(cpu / rt if rt else 0):.2f}] "
              f"{msg}", file=sys.stderr)
