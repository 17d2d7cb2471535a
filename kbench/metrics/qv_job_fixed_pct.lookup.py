"""Share of the jobs' wall in qv's work once a job (the program's spans
`qv.hist`: the table's histogram, and `qv.solve`: the QV model and the
CT, FR, ER, CV and QV lines)."""

from kbench import program


def read(run):
    return program.pct_of_jobs(run, program.host_s(run, ("qv.hist",
                                                         "qv.solve")))
