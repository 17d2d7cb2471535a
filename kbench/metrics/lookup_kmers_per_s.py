"""The assembly's k-mer windows looked up a second: each qv job's
windows in contigs of at least -l bases, over the window (first job's
start to last job's end)."""

from kbench.readers import rate as read  # noqa: F401
