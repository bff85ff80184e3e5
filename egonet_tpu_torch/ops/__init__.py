"""Device and host operators of the port.  Importing the package registers
both fused BasicBlock kernels as torch custom ops
(``egonet::fused_basic_block``, ``egonet::fused_basic_block_stencil``),
which loading an exported program (``io/export.py``) needs."""

from egonet_tpu_torch.ops import fused_block, fused_block_stencil  # noqa: F401
