"""PyTorch/CUDA port of the submodular selection library (``src/repro/`` is
the JAX reference).  Laid out like ``repro`` so each module has an obvious
counterpart; the hot loops run through hand-written CUDA kernels on the card
(``repro_torch.kernels``) and through their plain PyTorch versions on the
CPU.  Importing the package builds nothing and needs no GPU."""
