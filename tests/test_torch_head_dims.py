"""Every arch the port serves or trains has kernels for its head dim.

The README lists the attention archs the port serves and trains (yi-6b,
h2o-danube-3-4b, gemma3-4b, starcoder2-15b), the hybrid
recurrentgemma-9b and the attention-free rwkv6-7b.  The attention
wrappers refuse a CUDA tensor whose head dim is not in ``HEAD_DIMS``, and
the CPU tests run ``reduced()`` configs (head dim 16), so only this test
sees a full-width head dim that no kernel is instantiated for
(h2o-danube-3-4b: 3840 / 32 = 120).
"""

import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import HEAD_DIMS

SERVED_OR_TRAINED = ("yi-6b", "h2o-danube-3-4b", "gemma3-4b",
                     "starcoder2-15b", "recurrentgemma-9b", "rwkv6-7b")


@pytest.mark.parametrize("arch", SERVED_OR_TRAINED)
def test_head_dim_has_kernels(arch):
    cfg = get_config(arch)
    assert cfg.resolved_head_dim in HEAD_DIMS, (
        f"{arch}: head dim {cfg.resolved_head_dim} not in {HEAD_DIMS}")
