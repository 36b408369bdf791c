"""Set-up: process start to the first timed operation, in s (host clock)."""


def read(run):
    return run.setup_s
