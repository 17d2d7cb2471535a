"""Base encoding: ASCII -> 2-bit codes.

Reproduces the `seq_nt4_table` contract (misc.c:4-21): A/a=0, C/c=1,
G/g=2, T/t=3 (U/u too), everything else = 4 ("N"), which restarts the
k-mer window downstream.  Runs on the host as a numpy take.
"""

import numpy as np

NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
# RNA aliases, as in the reference table (misc.c:10,12: 'U'/'u' == 3).
NT4_TABLE[ord("U")] = 3
NT4_TABLE[ord("u")] = 3
