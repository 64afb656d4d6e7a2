"""The default training path held against the JAX package: ``Strategy()``
(bf16 compute over f32 masters, remat "minimal") with the model's default
``dtype="bfloat16"`` and per-layer remat, on the CPU.

Three adamw steps of a 2-layer SMALL config at S=128 (B=4) in both
packages from the same weights (``params_from_jax``) on one repeated
batch; the
JAX flash kernels run in interpret mode, as the JAX package's own CPU
tests run them. Each step's loss must agree within 2e-2 absolute (0.5%
of the ~4.16 loss): the two sides round to bf16 at the same places
(casts of the params, the activations, the logits), but their bf16
matmuls and reductions round in different orders, and a bf16 step is
2^-8 relative. A cast in a different place shows as a difference of
order 0.1 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
from dlrover_tpu.models.llama import llama_init as jax_init
from dlrover_tpu.models.llama import llama_logical_axes
from dlrover_tpu.models.llama import llama_loss_fn as jax_loss_fn
from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import LlamaConfig, llama_loss_fn, params_from_jax
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer

# the default dtype ("bfloat16") and per-layer remat; blocks of 64 keep
# the interpreted JAX kernels to a few grid steps
SMALL = dict(
    vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=96,
    max_seq_len=128, attn_impl="flash", attn_block_q=64, attn_block_k=64,
)
B, S, STEPS, LR = 4, 128, 3, 1e-2
LOSS_TOL = 2e-2


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_default_bf16_path_losses_match_jax():
    jc, tc = JaxConfig(**SMALL), LlamaConfig(**SMALL)
    assert jc.dtype == tc.dtype == "bfloat16" and jc.remat and tc.remat
    assert Strategy().compute_dtype == "bfloat16"
    assert Strategy().remat == JaxStrategy().remat == "minimal"
    p_np = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    # one batch, repeated: the loss must fall as the step learns it
    tokens = np.random.RandomState(3).randint(0, 64, (B, S + 1)).astype(
        np.int32)
    batches = [tokens] * STEPS

    j_res = jax_accelerate(
        jax_loss_fn(jc), lambda r: jax_init(jc, r),
        optax.adamw(LR, weight_decay=0.0), llama_logical_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(data=1)),
        devices=jax.devices()[:1])
    j_state, j_losses = j_res.state, []
    for i, tokens in enumerate(batches):
        j_state, m = j_res.train_step(
            j_state, {"tokens": jnp.asarray(tokens)}, jax.random.key(i))
        j_losses.append(float(m["loss"]))

    t_res = auto_accelerate(
        llama_loss_fn(tc), lambda seed, device: params_from_jax(p_np, device),
        build_optimizer("adamw", LR, weight_decay=0.0), Strategy(),
        device="cpu")
    t_state, t_losses = t_res.state, []
    for tokens in batches:
        t_state, m = t_res.train_step(t_state, {"tokens": tokens}, None)
        t_losses.append(m["loss"].item())

    assert all(np.isfinite(t_losses)) and t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_TOL, rtol=0)
