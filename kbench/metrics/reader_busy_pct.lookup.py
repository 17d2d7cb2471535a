"""Share of the jobs' wall that the native reader's producer thread was
busy, reading its input, parsing it and packing the planes (the
program's counters `reader.input_s`, `reader.parse_s`, `reader.pack_s`,
summed over the readers the window opened and closed).  `input_s` is
the time in gzread, which holds any wait on the input as well as the
reading and inflating: on a file in the page cache, as in the qv cell,
it is work.  Near 100 % the one producer thread sets the pace, by
parsing or by waiting on its input."""

from kbench import program

BUSY = ("reader.input_s", "reader.parse_s", "reader.pack_s")


def read(run):
    parts = [program.counter(run, name) for name in BUSY]
    return None if None in parts else program.pct_of_jobs(run, sum(parts))
