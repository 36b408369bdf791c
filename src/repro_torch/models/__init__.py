"""The training testbed's models (the JAX package's ``models/``): layer
primitives, attention (GQA, MLA, cross), MoE, Mamba2 / SSD and the model
assembly of every family: dense, moe, vlm, hybrid, ssm and audio."""
