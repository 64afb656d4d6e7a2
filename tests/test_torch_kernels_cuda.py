"""The port's CUDA kernels against their plain PyTorch versions, on the
card (bf16). These need an NVIDIA GPU and nvcc: without CUDA they skip
with a reason (a CUDA kernel has no CPU mode). Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: errors relative to the largest reference value, 2e-2 for o
and 3e-2 for gradients: the kernels round roped q/k, P and dS to bf16
before the tensor-core products, which the f32 plain versions do not.
"""

import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.ops import attention as att

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    return torch.device("cuda")


def _rel(got, want):
    diff = (got.float() - want.float()).abs().max()
    return (diff / want.float().abs().max()).item()


@pytest.mark.parametrize("B,H,KVH,S,rope", [
    (1, 4, 4, 128, True),
    (2, 8, 2, 200, True),     # GQA, ragged
    (1, 4, 1, 77, False),     # MQA, ragged, no rope
])
def test_kernels_match_plain(cuda, B, H, KVH, S, rope):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
    cos = sin = None
    if rope:
        ang = torch.randn(B, S, 64, generator=gen, device=cuda)
        cos = torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16)
        sin = torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin)
    out.backward(do)
    scale = 128 ** -0.5
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    args = (q, k, v, do, lse_p, delta_p, cos, sin, True, scale)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    assert _rel(out, o_p) < 2e-2
    assert _rel(leaves[0].grad, att.flash_bwd_dq_plain(*args)) < 3e-2
    assert _rel(leaves[1].grad, dk_p) < 3e-2
    assert _rel(leaves[2].grad, dv_p) < 3e-2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        att.flash_fwd(q, q, q, None, None, True, 0.125)
    q32 = torch.zeros(1, 2, 16, 128, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        att.flash_fwd(q32, q32, q32, None, None, True, 0.125)
