"""Training-mesh helpers; :func:`repro_torch.distributed.sharding.data_axes`
names a mesh's data axes."""
