"""Training on a mesh: the per-architecture sharding rules
(:mod:`~repro_torch.distributed.sharding`) and the activation-sharding
context the model code reads (:mod:`~repro_torch.distributed.act_sharding`)."""
