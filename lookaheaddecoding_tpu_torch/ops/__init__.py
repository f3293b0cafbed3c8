"""Attention kernel (CUDA C++ under csrc/), its plain version and build.

The kernel wrapper is ``ops.lookahead_attention.lookahead_attention``; the
submodule is not shadowed by a package-level name, so its launch counts
stay reachable as ``ops.lookahead_attention.counts``.
"""
