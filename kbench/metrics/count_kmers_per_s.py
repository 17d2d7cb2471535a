"""The reads' k-mer windows counted a second: each count job's windows,
counted once however many passes its options make, over the window
(first job's start to last job's end)."""

from kbench.readers import rate as read  # noqa: F401
