"""Share of the jobs' wall that the program waited for each native
reader's first chunk (the program's span `reader.fill`): the latency of
starting a reader, before any device work of the job's input."""

from kbench import program


def read(run):
    return program.pct_of_jobs(run, program.host_s(run, ("reader.fill",)))
