"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""


def read(run):
    b = run.memory_peak_bytes
    return b / 2**30 if b else None
