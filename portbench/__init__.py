"""The port's benchmark: one run of one cell is ``python3 portbench/run.py``."""
