"""Card-only tests of the port's CUDA kernels, each against its plain
PyTorch version. They skip without a CUDA device. This file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    # fp32 sums in another order and an online softmax
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    # bf16 output; p rounded to bf16 against a running vs a row maximum
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_attention_kernel_matches_plain_version(dtype, tol):
    """The composite-attention kernel: composite and causal, one and many
    KV tiles, with and without a sliding window, GQA rep 8 and 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    big = dict(level=7, window=20, guess_size=6)       # S = 240
    small = dict(level=4, window=5, guess_size=3)      # S = 27
    cases = [(240, 32, 1024, 512, False, 0, big),
             (240, 32, 2048, 1808, False, 0, big),
             (128, 32, 1024, 640, True, 0, big),
             (240, 32, 1024, 600, False, 300, big),
             (1, 32, 1024, 700, True, 0, big),
             (27, 16, 256, 37, False, 16, small),
             (27, 16, 256, 0, False, 0, small)]
    for s, hq, m, kv, causal, sw, geo in cases:
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, dtype)
        q, k, v = mk(s, hq, 64), mk(4, m, 64), mk(4, m, 64)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        kw = dict(geo, causal=causal, sliding_window=sw)
        before = la.counts["kernel"]
        got = la.lookahead_attention(q, k, v, kv_len, **kw)
        assert la.counts["kernel"] == before + 1
        want = la.lookahead_attention_ref(q, k, v, kv_len, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
