"""The port's manual tensor-parallel annotation
(dlrover_tpu_torch/parallel/manual_tp.py) against the JAX package's
(dlrover_tpu/parallel/manual_tp.py): JAX's ``TestManualTP`` cases
(tests/test_parallel.py) on the port's flat dotted names, and the axes
``TPInfo`` emits driving the Llama's tensor path on 4 gloo ranks
(``tensor=2, data=2``), three adamw steps against JAX's
``auto_accelerate`` with the same axes on 4 virtual devices.

Tolerances: tests/test_torch_mesh_gloo.py's (losses 1e-5 absolute;
params by the Adam statistic there).
"""

import numpy as np
import pytest
from test_torch_mesh_gloo import _assert_adam_params, _port_train
from test_torch_seq_mesh_gloo import _jax_train, _spawn

from dlrover_tpu_torch.models import LlamaConfig, llama_init, llama_loss_fn
from dlrover_tpu_torch.parallel.manual_tp import TPInfo

CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           mlp_dim=64, max_seq_len=32, attn_impl="reference", remat=False,
           dtype="float32")
MESH = dict(data=2, tensor=2)
STEPS = 3


def _tp(cls):
    tp = cls(vocab_size=64)
    tp.shard_col("wq", "wk", "wv", "w_gate", "w_up")
    tp.shard_row("wo", "w_down")
    tp.shard_vocab("embed", "lm_head")
    return tp


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _jax_axes():
    import jax

    from dlrover_tpu.models import llama_init as jax_init
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.parallel.manual_tp import TPInfo as JaxTPInfo

    params = jax_init(JaxConfig(**CFG), jax.random.key(0))
    return params, _tp(JaxTPInfo).build_axes(params)


def test_axes_match_llama_conventions():
    """Column parallel shards the output dim, row parallel the input dim,
    vocab parallel the vocab-sized dim, unmatched params replicate; the
    same axes as JAX's for every param."""
    axes = _tp(TPInfo).build_axes(llama_init(LlamaConfig(**CFG), 0, "cpu"))
    assert axes["layers.wq"] == ("layer", None, "mlp")
    assert axes["layers.w_up"] == ("layer", None, "mlp")
    assert axes["layers.wo"] == ("layer", "mlp", None)
    assert axes["layers.w_down"] == ("layer", "mlp", None)
    assert axes["embed"] == ("vocab", None)
    assert axes["lm_head"] == (None, "vocab")
    assert axes["final_norm"] == (None,)
    assert axes == _flat(_jax_axes()[1])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_vocab_without_size_refuses_ambiguous_2d(package):
    """Without vocab_size a 2-D vocab param is ambiguous and raises; a
    1-D vocab-length bias shards its only dim; a vocab_size no dim has
    raises."""
    if package == "jax":
        from dlrover_tpu.parallel.manual_tp import TPInfo as cls
    else:
        cls = TPInfo
    params = {"lm_head": np.zeros((32, 64)), "bias": np.zeros((64,))}
    with pytest.raises(ValueError, match="ambiguous"):
        cls().shard_vocab("lm_head").build_axes(params)
    assert cls().shard_vocab("bias").build_axes(
        {"bias": np.zeros((64,))}) == {"bias": ("vocab",)}
    with pytest.raises(ValueError, match="no dim of size 48"):
        cls(vocab_size=48).shard_vocab("lm_head").build_axes(
            {"lm_head": np.zeros((32, 64))})
    # a row-parallel bias stays replicated; a stacked one keeps its layer
    assert cls().shard_row("b").build_axes(
        {"b": np.zeros((8,)), "layers.b": np.zeros((2, 8))}) == {
            "b": (None,), "layers.b": ("layer", None)}


def _worker(rank, tmp, inputs):
    from dlrover_tpu_torch.models import params_from_jax
    from dlrover_tpu_torch.parallel import MeshConfig

    cfg = LlamaConfig(**CFG)
    axes = _tp(TPInfo).build_axes(params_from_jax(inputs["params"]))
    got = _port_train(llama_loss_fn(cfg), inputs["params"], axes,
                      MeshConfig(**MESH),
                      [{"tokens": inputs["tokens"]}] * STEPS)
    got["axes"] = axes
    return got


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    import jax

    params, _ = _jax_axes()
    inputs = {"params": jax.tree.map(np.asarray, params),
              "tokens": np.random.RandomState(2).randint(
                  0, 64, (8, 17)).astype(np.int32)}
    return inputs, _spawn(tmp_path_factory.mktemp("manual_tp"), 4, _worker,
                          inputs)


def test_manual_tp_trains_as_jax(tp_run):
    """The emitted axes place the params over tensor (``wq`` on its
    columns) and drive the Llama's tensor path: the losses and params of
    three steps equal JAX's with the same axes and mesh."""
    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from torch.distributed.tensor import Replicate, Shard

    inputs, saved = tp_run
    _, jax_axes = _jax_axes()
    ref_losses, ref_params = _jax_train(
        jax_loss(JaxConfig(**CFG)), inputs["params"], jax_axes, MESH,
        [{"tokens": inputs["tokens"]}] * STEPS)
    for got in saved:
        assert got["placements"]["layers.wq"] == (Replicate(), Replicate(),
                                                  Shard(2))
        assert got["placements"]["embed"] == (Replicate(), Replicate(),
                                              Shard(0))
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        _assert_adam_params(got["params"], ref_params)
    assert all(got["losses"] == saved[0]["losses"] for got in saved)
