"""The serving front doors (the JAX package's ``repro.launch`` serving
modules): the coalescer, ``SelectionServer``, ``AsyncSelectionServer``,
long-lived sessions, and their metrics, faults and resilience layers."""
