"""The training testbed's models (the JAX package's ``models/``): layer
primitives, attention and the decoder-only ``dense`` and ``vlm`` families.
The other families (MoE, Mamba, MLA, whisper) are ROADMAP item 12.2."""
