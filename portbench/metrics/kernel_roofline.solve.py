"""Least time of the traced solves' required work (portbench/work.py) over
the device's busy time in the traced window, in %."""


def read(run):
    return run.roofline_pct()
