"""Architecture configs: :class:`~repro_torch.configs.base.ArchConfig` and the
registered architectures (``configs/archs.py``)."""
