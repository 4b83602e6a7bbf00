"""The port's kernels: each CUDA kernel's wrapper, its plain PyTorch
version, the reference's oracles (:mod:`repro_torch.kernels.ref`) and the
layers built on them (:mod:`repro_torch.kernels.ops`). Sources live in
``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first use.

The public names follow ``repro.kernels``: ``cheb_attn``, ``flash_attn``,
``poly_attn`` and ``wkv_chunked`` (functions; their modules stay reachable
through ``sys.modules`` or ``importlib.import_module``), the layer
``cheb_attn_layer``, ``ref`` and ``ops``. The reference's TPU block model
(``select_block_sizes``, ``resolve_interpret``, ``clear_block_cache``) has
no counterpart: each kernel's ``launch_plan`` picks its tiles. Nor has
``cheb_attn_diff``: ``cheb_attn`` is differentiable itself."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cheb_attn import cheb_attn
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.ops import cheb_attn_layer
from repro_torch.kernels.poly_attn import poly_attn
from repro_torch.kernels.wkv_chunk import wkv_chunked
