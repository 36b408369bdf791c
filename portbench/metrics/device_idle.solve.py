"""Share of the traced window with no operation on the device, in %."""


def read(run):
    return run.idle_pct()
