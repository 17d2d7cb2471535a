"""Share of the jobs' wall spent waiting for the next chunk of input."""

from kbench.readers import INGEST_SPANS as SPANS  # noqa: F401
from kbench.readers import ingest_wait_pct as read  # noqa: F401
