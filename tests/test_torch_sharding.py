"""The port's logical rule table on a DeviceMesh against the JAX
package's: for every param of the Llama and GPT-2 presets and each mesh
of the data, fsdp and tensor axes over 4 ranks, the DTensor placements
the port gives equal the placements that JAX's ``logical_to_mesh_axes``
spec names (each mesh axis of the spec shards its tensor dim, the other
mesh dims replicate).

One process: the DeviceMesh is laid over torch's fake process group (4
ranks, this process rank 0), which runs no collective; placements do not
depend on the rank. The group is destroyed after each test.
"""

import dataclasses

import pytest
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from dlrover_tpu.models.gpt2 import GPT2_PRESETS as JAX_GPT2_PRESETS
from dlrover_tpu.models.gpt2 import gpt2_logical_axes as jax_gpt2_axes
from dlrover_tpu.models.llama import PRESETS as JAX_LLAMA_PRESETS
from dlrover_tpu.models.llama import llama_logical_axes as jax_llama_axes
from dlrover_tpu.parallel.sharding import (
    logical_to_mesh_axes as jax_logical_to_mesh_axes,
)
from dlrover_tpu_torch.models import (
    GPT2_PRESETS,
    PRESETS,
    gpt2_logical_axes,
    llama_logical_axes,
)
from dlrover_tpu_torch.parallel import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.sharding import (
    logical_placements,
    logical_to_mesh_axes,
)

MESHES = {
    "data4": MeshConfig(),
    "fsdp4": MeshConfig(data=1, fsdp=4),
    "fsdp2-tensor2": MeshConfig(data=1, fsdp=2, tensor=2),
    "data2-tensor2": MeshConfig(data=2, tensor=2),
}


@pytest.fixture
def fake_group():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def _flat(tree, prefix=""):
    """A nested dict of logical axes by dotted name."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _from_jax_spec(spec, names):
    """The placements a JAX PartitionSpec names on mesh dims ``names``."""
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            if axis in names:
                placements[names.index(axis)] = Shard(dim)
    return tuple(placements)


def _models():
    for name in sorted(PRESETS):
        yield (f"llama-{name}", llama_logical_axes(PRESETS[name]),
               _flat(jax_llama_axes(JAX_LLAMA_PRESETS[name])))
    for name in sorted(GPT2_PRESETS):
        for tie in (True, False):
            cfg = dataclasses.replace(GPT2_PRESETS[name], tie_lm_head=tie)
            jcfg = dataclasses.replace(JAX_GPT2_PRESETS[name],
                                       tie_lm_head=tie)
            yield (f"gpt2-{name}-tie{int(tie)}", gpt2_logical_axes(cfg),
                   _flat(jax_gpt2_axes(jcfg)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_equal_jax_specs(fake_group, mesh_name):
    mesh = build_mesh(MESHES[mesh_name])
    dm = mesh.device_mesh
    names = list(dm.mesh_dim_names)
    assert names == [a for a in ("data", "fsdp", "tensor")
                     if a in ("data", "fsdp") or mesh.shape[a] > 1]
    checked = 0
    for model, axes, jax_axes in _models():
        assert set(axes) == set(jax_axes), model
        for param, logical in axes.items():
            spec = jax_logical_to_mesh_axes(jax_axes[param])
            assert logical_to_mesh_axes(logical) == tuple(spec), (model,
                                                                  param)
            got = logical_placements(logical, dm)
            assert got == _from_jax_spec(spec, names), (model, param)
            checked += 1
    assert checked > 50


def test_rule_resolution_matches_jax():
    """An axis appears once (a later dim falls back to replicated), a
    tuple rule shards one dim over two axes, trailing Nones drop, and
    custom rules move an axis."""
    cases = [("batch", "seq", "embed"), ("embed", "mlp"),
             ("vocab", "embed"), ("layer", "heads", "embed"),
             ("embed", "embed"), None, ()]
    rules = (("embed", ("data", "fsdp")), ("mlp", "tensor"))
    for axes in cases:
        for r in (None, rules):
            assert logical_to_mesh_axes(axes, r) == tuple(
                jax_logical_to_mesh_axes(axes, r)), (axes, r)


def test_batch_placements_and_order(fake_group):
    """The batch shards its rows over data then fsdp (data major, JAX's
    order); a dim over two mesh axes in the reverse order raises."""
    dm = build_mesh(MeshConfig(data=2, fsdp=2)).device_mesh
    assert logical_placements(("batch", "seq"), dm) == (Shard(0), Shard(0))
    with pytest.raises(NotImplementedError, match="mesh order"):
        logical_placements(("batch",), dm, rules=(("batch",
                                                   ("fsdp", "data")),))


# ---------------------------------------------------------------------------
# what a DeviceMesh still refuses
# ---------------------------------------------------------------------------

TINY = dataclasses.replace(PRESETS["tiny"], attn_impl="flash")


@pytest.mark.parametrize("config,item", [
    (MeshConfig(data=1, pipe=4), "item 10"),
], ids=["pipe"])
def test_build_mesh_over_a_group_refuses(fake_group, config, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        build_mesh(config)


@pytest.mark.parametrize("config,dims", [
    (MeshConfig(data=1, expert=2, seq=2), ("data", "fsdp", "expert", "seq")),
    (MeshConfig(data=1, seq=2, fsdp=2), ("data", "fsdp", "seq")),
    (MeshConfig(data=1, seq=2, tensor=2), ("data", "fsdp", "seq", "tensor")),
], ids=["expert", "seq-fsdp", "seq-tensor"])
def test_build_mesh_over_a_group_places_seq(fake_group, config, dims):
    """A seq axis of one rank a process beside other axes is a dim of the
    DeviceMesh in the JAX package's device order (inside data, fsdp and
    expert, outside tensor), its ring the dim's sub-group; a process
    that would hold some but not all of the seq ranks raises."""
    mesh = build_mesh(config)
    assert mesh.device_mesh.mesh_dim_names == dims
    assert mesh.ring.kind == "process-group" and mesh.ring.size == 2
    assert mesh.ring.ranks == (mesh.device_mesh.get_local_rank("seq"),)
    with pytest.raises(ValueError, match="2 of the 4 seq ranks"):
        build_mesh(dataclasses.replace(config, seq=4))


@pytest.mark.parametrize("optimizer", ["rmsprop", "adagrad"])
def test_optimizers_without_a_mesh_path_raise(fake_group, optimizer):
    """An optimizer steps DTensor params only when it declares
    ``steps_on_mesh`` (the port's optimizers) or is torch's AdamW, Adam
    or SGD; torch's others raise naming item 7."""
    import torch

    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate

    make = {"rmsprop": torch.optim.RMSprop,
            "adagrad": torch.optim.Adagrad}[optimizer]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        auto_accelerate(
            llama_loss_fn(TINY), lambda s, d: llama_init(TINY, s, d),
            lambda params: make([p for _, p in params], lr=1e-3),
            Strategy(mesh=MeshConfig(data=1, fsdp=4), remat="none",
                     compute_dtype="float32"),
            device="cpu", param_logical_axes=llama_logical_axes(TINY))


def test_a_mesh_places_params_and_moments_and_takes_custom_rules(
        fake_group):
    """On a DeviceMesh the rule table is the only description of the
    parallelism: default rules shard ``embed`` over fsdp, custom rules
    move it (here onto ``mlp``), and AdamW's moments follow their
    params."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.parallel.strategy import DEFAULT_RULES
    from dlrover_tpu_torch.trainer import build_optimizer
    from dlrover_tpu_torch.trainer.optim import materialize_optimizer_state

    custom = tuple(("mlp", "fsdp") if n == "mlp" else
                   ("embed", None) if n == "embed" else (n, a)
                   for n, a in DEFAULT_RULES)
    for rules, dim in ((DEFAULT_RULES, 1), (custom, 2)):
        res = auto_accelerate(
            llama_loss_fn(TINY), lambda s, d: llama_init(TINY, s, d),
            build_optimizer("adamw", 1e-3),
            Strategy(mesh=MeshConfig(data=1, fsdp=4), remat="none",
                     compute_dtype="float32", rules=rules),
            device="cpu", param_logical_axes=llama_logical_axes(TINY))
        w_up = res.state.params["layers.w_up"]
        assert tuple(w_up.placements) == (Replicate(), Shard(dim))
        assert w_up.to_local().shape[dim] == w_up.shape[dim] // 4
        materialize_optimizer_state(res.state.optimizer)
        moment = res.state.optimizer.state[w_up]["exp_avg"]
        assert tuple(moment.placements) == tuple(w_up.placements)


def test_gpt2_under_a_tensor_axis_raises(fake_group):
    import torch

    from dlrover_tpu_torch.models import GPT2Config, gpt2_apply, gpt2_init
    from dlrover_tpu_torch.parallel.sharding import distribute_logical

    cfg = GPT2Config(vocab_size=64, dim=128, n_layers=2, n_heads=2,
                     mlp_dim=256, max_seq_len=64, dtype="float32")
    dm = build_mesh(MeshConfig(data=1, fsdp=2, tensor=2)).device_mesh
    axes = gpt2_logical_axes(cfg)
    params = {k: distribute_logical(v, axes[k], dm)
              for k, v in gpt2_init(cfg, 0, "cpu").items()}
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        gpt2_apply(cfg, params, torch.zeros(2, 8, dtype=torch.long))
