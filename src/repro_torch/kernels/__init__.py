"""The port's kernels: each CUDA kernel's wrapper, its plain PyTorch
version, the reference's oracles (:mod:`repro_torch.kernels.ref`) and the
layers built on them (:mod:`repro_torch.kernels.ops`). Sources live in
``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first use.

The public names follow ``repro.kernels`` where the port has them:
``flash_attn``, ``poly_attn`` and ``wkv_chunked`` (functions; their modules
stay reachable through ``sys.modules`` or ``importlib.import_module``),
``ref`` and ``ops``. The layer's ``cheb_attn`` is reached through
:mod:`repro_torch.kernels.cheb_attn` or ``ops``."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.poly_attn import poly_attn
from repro_torch.kernels.wkv_chunk import wkv_chunked
