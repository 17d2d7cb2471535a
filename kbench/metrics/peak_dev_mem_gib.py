"""The most device memory the program held at once in the window
(`torch.cuda.max_memory_allocated` after a reset at its start), GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
