"""Time per solve: the window over the solves completed in it, in s
(host clock; the window ends with its last solve)."""


def read(run):
    return run.window_s / run.solves if run.solves else None
