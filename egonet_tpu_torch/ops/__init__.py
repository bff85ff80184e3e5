"""Device and host operators of the port.  Both fused BasicBlock kernels
are torch operators (``egonet::fused_basic_block``,
``egonet::fused_basic_block_stencil``) defined in C++ and loaded at first
use (``_build.load_ops``); importing this package registers nothing."""
