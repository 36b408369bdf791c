"""The training substrate (the JAX package's ``train/``): AdamW, global-norm
clipping, the cosine schedule, int8 gradient compression with error feedback
and the train step."""
