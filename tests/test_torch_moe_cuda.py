"""The MoE layer, Ulysses and K1-K4 at Mixtral-8x7B's attention shape, on
the card. These need an NVIDIA GPU and nvcc: without CUDA they skip with
a reason. Run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py

Tolerances:

- the MoE layer in bf16 on the card against its f32 result on the CPU
  from the same bf16-rounded inputs: the router's logits are bf16 on
  the card, so a token whose top-k choice is a near tie may route
  differently (and shift the buffer positions of the later routes to
  the experts it touches, which the output does not see); at least 97%
  of the (token, slot) routes must agree in expert and keep, and on the
  tokens whose routes all agree the output within 2e-2 of the largest
  reference value; aux and z within 2e-2 (relative), the dropped share within
  0.01;
- Ulysses over 4 in-process ranks against ``flash_attention`` over all
  heads: the same kernels on the same heads, so output and gradients
  within 1e-6 of the largest value (equal expected);
- K1-K4 at [1, 32, 4096, 128] with 8 kv heads against their plain
  versions: tests/test_torch_kernels_cuda.py's 2e-2 for o and 3e-2 for
  the gradients.
"""

import pytest
import torch

from dlrover_tpu_torch.device import CUDA_SKIP_REASON, cuda_available
from dlrover_tpu_torch.ops import attention as att
from dlrover_tpu_torch.parallel import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel import moe
from dlrover_tpu_torch.parallel.sequence import ulysses_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not cuda_available():
        pytest.skip(CUDA_SKIP_REASON)
    return torch.device("cuda")


def _rel(got, want):
    diff = (got.float() - want.float()).abs().max()
    return (diff / want.float().abs().max()).item()


def _route_keys(x, params, cfg):
    """Each (token, slot)'s (expert, kept) under ``x``'s dtype."""
    routes = moe._routes(x @ params["router"].to(x.dtype), cfg)
    return torch.stack([routes.expert, routes.kept.long()], dim=-1)


def test_moe_layer_bf16_on_the_card_matches_f32_on_the_cpu(cuda):
    cfg = moe.MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25)
    params = moe.moe_init(0, 8, 1024, 2048, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, 1024, generator=gen, device=cuda)
    x16 = x.to(torch.bfloat16)
    p16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    y16, m16 = moe.moe_ffn(x16, p16, cfg)
    x32 = x16.float().cpu()
    p32 = {k: v.float().cpu() for k, v in p16.items()}
    y32, m32 = moe.moe_ffn(x32, p32, cfg)

    same = (_route_keys(x16, p16, cfg).cpu()
            == _route_keys(x32, p32, cfg)).all(dim=-1)       # [G, T, k]
    assert same.float().mean().item() >= 0.97
    token_ok = same.all(dim=-1)                              # [G, T]
    assert _rel(y16.float().cpu()[token_ok], y32[token_ok]) < 2e-2
    for name in ("aux_loss", "z_loss"):
        want = m32[name].item()
        assert abs(m16[name].item() - want) <= 2e-2 * abs(want)
    assert abs(m16["dropped"].item() - m32["dropped"].item()) <= 0.01


def test_ulysses_in_process_on_the_card_matches_flash(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(2, h, 2048, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (8, 8, 8, 8))
    mesh = build_mesh(MeshConfig(seq=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = att.launches()
    out = ulysses_attention(*leaves, mesh=mesh, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    after = att.launches()
    for name in ("flash_fwd", "flash_bwd_preprocess", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        assert after[name] == before[name] + 4
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = att.flash_attention(*ref_leaves, causal=True)
    ref.backward(do)
    assert _rel(out, ref) <= 1e-6
    for got, want in zip(leaves, ref_leaves):
        assert _rel(got.grad, want.grad) <= 1e-6


def test_kernels_at_the_mixtral_attention_shape(cuda):
    """K1-K4 at Mixtral-8x7B's attention (32 heads over 8 kv heads of
    128, S 4096, causal, rope in the kernels) against their plain
    versions."""
    B, H, KVH, S = 1, 32, 8, 4096
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(B, h, S, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for h in (H, KVH, KVH, H))
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
