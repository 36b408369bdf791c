"""The training pipeline's data stages; :mod:`repro_torch.data.selection` is
the submodular selection stage."""
