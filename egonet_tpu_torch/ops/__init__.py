"""Device and host operators of the port.  Both fused BasicBlock kernels
and the rigid solve are torch operators (``egonet::fused_basic_block``,
``egonet::fused_basic_block_stencil``, ``egonet::rigid_solve``) defined in
C++ and loaded at first use (``_build.load_ops``); importing this package
registers nothing."""
