"""The port's kernels (CUDA C++ under csrc/), their wrappers and plain
versions, the weight quantizer, and the build.

The wrappers are ``ops.lookahead_attention.lookahead_attention`` and
``paged_lookahead_attention``, ``ops.quant_matmul.int8_matmul`` /
``int4_matmul``, and the micro-benchmark's
``ops.int4_micro.int4_matmul_shift`` / ``int4_matmul_kouter``; the
submodules are not shadowed by package-level names, so their launch counts
stay reachable as ``ops.lookahead_attention.counts`` / ``paged_counts``,
``ops.quant_matmul.counts`` and ``ops.int4_micro.counts``.
"""
