"""Seconds from the start of the run to the start of the window: import,
kernel load (and, in a fresh checkout, their build), inputs, warm-up."""


def read(run):
    return run.setup_s
