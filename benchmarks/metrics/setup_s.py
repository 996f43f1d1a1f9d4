"""Seconds from the start of the run's process to the start of its
window: imports, the CUDA context, the kernel libraries, the traffic,
the table build, the offsets and one warm-up solve."""


def read(run):
    return run.setup_s
