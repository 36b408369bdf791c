"""Atomic on-disk checkpoints of numpy payloads (what the serving sessions'
journal needs of the JAX package's ``repro.ckpt``)."""
