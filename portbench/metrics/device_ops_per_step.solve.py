"""Kernels on the device in the traced window, the port's and torch's, per
greedy step."""


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    return run.trace.kernels / run.trace_steps
