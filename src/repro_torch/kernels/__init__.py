"""The port's kernels: each CUDA kernel's wrapper, its plain PyTorch
version (:mod:`repro_torch.kernels.ref`) and the layers built on them
(:mod:`repro_torch.kernels.ops`). Sources live in ``csrc/`` and are built
by :mod:`repro_torch.kernels._build` at first use."""
