"""The port's kernels (CUDA C++ under csrc/), their wrappers and plain
versions, the weight quantizer, and the build.

The wrappers are ``ops.lookahead_attention.lookahead_attention`` and
``ops.quant_matmul.int8_matmul`` / ``int4_matmul``; the submodules are not
shadowed by package-level names, so their launch counts stay reachable as
``ops.lookahead_attention.counts`` and ``ops.quant_matmul.counts``.
"""
