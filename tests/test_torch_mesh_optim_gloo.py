"""Every optimizer of the port on a DeviceMesh, over 4 gloo processes on
the CPU: held against the JAX package's ``auto_accelerate`` on 4 of its
virtual CPU devices with the same meshes, and against the port's own
unsharded step.

One spawn runs every case. For each mesh (``fsdp=4``, ``fsdp=2,
tensor=2``, ``data=2, tensor=2``):

- three steps of the ``tiny`` Llama (flash attention, f32 compute, remat
  none, JAX-made weights and batches) through ``auto_accelerate`` with
  each optimizer: ``fused_adamw`` (bits 32, bits 32 with a ``clip_norm``
  the grad norm crosses, bits 8), per-leaf ``Adam8bit``, AGD, group
  Adam and Adagrad, muP's Adam, ``OffloadAdam``, and the decoupled WSAM
  step over AdamW. JAX runs the same optax transformations through its
  ``auto_accelerate``; ``OffloadAdam`` and WSAM, which are no optax
  transformations, take JAX's grads on its mesh in a loop of their own
  (``OffloadAdam.step``, a jitted ``make_wsam_step_fn``). The 8-bit
  optimizers take JAX's rounding fields through their ``uniform`` hook.
  Each rank's state layout is recorded: param-shaped moments are
  DTensors placed as their params; the rest (flat moments, 8-bit codes
  and scales, group Adam's row counts) is a plain tensor of the global
  layout, as the JAX package replicates it.
- the optimizer alone over a tree with the tiny Llama's shapes and
  placements, three steps on seeded grads placed as the params: every
  param and every state entry, whole, against the same optimizer on
  plain tensors and the same grads. The clip case's grads are scaled so
  that the global norm crosses ``clip_norm`` (above, below, above); the
  group Adam case's grads leave some embedding rows untouched and touch
  others only in the columns one fsdp rank holds, so a per-rank row
  test would differ from the global one.

Each process is spawned and imports this module, so its top level
imports the port only; the JAX package is imported in the test's own
process. The processes meet through a FileStore in a temporary directory
and are killed after ``GLOO_DEADLINE_S`` (a hang guard: in a loaded
``-n 6`` run the first case, which waits for the spawn, took 139 s).

Tolerances. Against JAX: losses within 1e-5; f32 params by
tests/test_torch_mesh_gloo.py's statistic (median below 1e-6, 99th
percentile below 0.2% of one learning-rate step, every difference below
25% of one); 8-bit params by the largest difference of
tests/test_torch_optim.py's 8-bit tolerance (at most 0.1 of how far the
params moved: a nu code on the other side of a rounding edge) and the
f32 statistic's median (below 1e-6). That test holds the 8-bit steps to
a median of 1e-6 of the movement on the same grads; here the two
packages' grads differ by their sums' order, which alone moves the
median to about that (1.03e-6 at adam8bit-fsdp4), so the median is held
as the f32 runs' is; the optimizer-alone cases below hold the mesh step
to the unsharded one bit for bit. Against the port's unsharded run of
the same model: losses within 1e-5 (the grads' sums run in another
order). The optimizer alone: bit
for bit, every optimizer and every state entry (the replicated states
are updated over whole arrays, the param-shaped ones elementwise on the
local shards, and group Adam's bias corrections over every row's
count); the mesh-wide norm within 1e-6 relative of the plain one (its
sums run in another order).
"""

import dataclasses
import faulthandler
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.models import (
    PRESETS,
    llama_logical_axes,
    llama_loss_fn,
    params_from_jax,
)
from dlrover_tpu_torch.ops.fused_optim import (
    FusedAdamW,
    flatten_meta,
    fused_adamw,
    tree_order,
)
from dlrover_tpu_torch.optimizers import (
    AGD,
    Adam8bit,
    GroupAdagrad,
    GroupAdam,
    OffloadAdam,
    agd,
    group_adagrad,
    group_adam,
    make_wsam_step_fn,
    mup_adam,
)
from dlrover_tpu_torch.parallel import MeshConfig, Strategy, auto_accelerate
from dlrover_tpu_torch.parallel import accelerate as accelerate_lib
from dlrover_tpu_torch.parallel.accelerate import global_value, steps_on_mesh
from dlrover_tpu_torch.parallel.mesh import batch_place, build_mesh
from dlrover_tpu_torch.parallel.mesh_state import global_norm
from dlrover_tpu_torch.parallel.sharding import distribute_logical
from dlrover_tpu_torch.trainer import build_optimizer

N = 4
LR = 1e-2
STEPS = 3
CLIP = 1.2  # the tiny Llama's grad norms are 1.09-1.33 over these steps
MUP_WIDTH = 2.0
GLOO_DEADLINE_S = 480
MESHES = {
    "fsdp4": dict(data=1, fsdp=4),
    "fsdp2-tensor2": dict(data=1, fsdp=2, tensor=2),
    "data2-tensor2": dict(data=2, tensor=2),
}
TINY = dataclasses.replace(PRESETS["tiny"], attn_impl="flash",
                           attn_block_q=16, attn_block_k=16)
OPTIMIZERS = ("fused_adamw32", "fused_adamw32_clip", "fused_adamw8",
              "adam8bit", "agd", "group_adam", "group_adagrad", "mup_adam",
              "offload_adam", "wsam")
EIGHT_BIT = ("fused_adamw8", "adam8bit")
# the optimizer-alone cases (WSAM is a step over a loss, not an
# optimizer: it is held end to end only)
ALONE = OPTIMIZERS[:-1]


# ---------------------------------------------------------------- inputs


def _inputs():
    """The seeded inputs of every case, as numpy: JAX-made params, the
    token batches, JAX's 8-bit rounding fields, and the optimizer-alone
    cases' grads."""
    import jax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_init as jax_init
    from dlrover_tpu.ops import fused_optim as jfo

    tree = jax_init(JaxConfig(**dataclasses.asdict(TINY)), jax.random.key(0))
    params = jax.tree.map(np.asarray, tree)
    rng = np.random.RandomState(0)
    flat = params_from_jax(params)
    names = tree_order(flat)
    meta = flatten_meta([flat[k] for k in names])
    padded = jfo.flatten_meta(tree).total_rows
    fused_u = {c: np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), c),
        (padded, jfo.BLOCK)))[:meta.total_rows]
        for c in range(1, STEPS + 1)}
    leaf_u = {(c, i): np.array(jax.random.uniform(
        jax.random.key(c * 7919 + i), (rows, jfo.BLOCK)))
        for c in range(1, STEPS + 1)
        for i, rows in enumerate(meta.rows)}
    return {
        "params": params,
        "tokens": [rng.randint(0, TINY.vocab_size, (8, 33)).astype(np.int32)
                   for _ in range(STEPS)],
        "fused_u": fused_u, "leaf_u": leaf_u,
        "grads": _alone_grads({k: v.numpy() for k, v in flat.items()}),
    }


def _alone_grads(flat):
    """Per optimizer-alone case, three steps of grads by param name."""
    rng = np.random.RandomState(1)
    base = [{k: rng.randn(*v.shape).astype(np.float32) * 0.1
             for k, v in flat.items()} for _ in range(STEPS)]
    grads = {name: base for name in ALONE}
    # the clip case: global norms 2, 0.5 and 2 times clip_norm
    grads["fused_adamw32_clip"] = [
        {k: g * np.float32(f * CLIP / _norm(step)) for k, g in step.items()}
        for step, f in zip(base, (2.0, 0.5, 2.0))]
    # group Adam: embedding rows 64-127 untouched, 0-63 touched only in
    # columns 0-15 (one fsdp rank's under fsdp=4 and fsdp=2), and layer
    # 1 of w_up untouched
    sparse = []
    for step in base:
        step = {k: g.copy() for k, g in step.items()}
        step["embed"][64:128] = 0.0
        step["embed"][:64, 16:] = 0.0
        step["layers.w_up"][1] = 0.0
        sparse.append(step)
    grads["group_adam"] = grads["group_adagrad"] = sparse
    return grads


def _norm(step) -> float:
    return float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in step.values())))


def _rows(x, config):
    """This rank's rows of a global batch leaf."""
    index, count = batch_place(config)
    return np.split(np.asarray(x), count)[index]


# ------------------------------------------------------------ port side


def _factory(name, inputs=None):
    """``named params -> optimizer`` of a case; the 8-bit ones take JAX's
    rounding fields from ``inputs``, their own draws without."""
    axes = llama_logical_axes(TINY)
    fused_u = leaf_u = None
    if inputs is not None:
        fields, leaf_fields = inputs["fused_u"], inputs["leaf_u"]
        fused_u = lambda c, shape: fields[c]  # noqa: E731
        leaf_u = lambda c, i, shape: leaf_fields[c, i]  # noqa: E731
    return {
        "fused_adamw32": fused_adamw(LR),
        "fused_adamw32_clip": fused_adamw(LR, clip_norm=CLIP),
        "fused_adamw8": lambda ps: FusedAdamW(ps, lr=LR, bits=8,
                                              uniform=fused_u),
        "adam8bit": lambda ps: Adam8bit(ps, lr=LR, uniform=leaf_u),
        "agd": agd(LR),
        "group_adam": group_adam(LR),
        "group_adagrad": group_adagrad(LR),
        "mup_adam": mup_adam(LR, axes, MUP_WIDTH),
        "offload_adam": lambda ps: OffloadAdam(ps, lr=LR),
        "wsam": build_optimizer("adamw", LR, weight_decay=0.0),
    }[name]


def _layout(optimizer, params) -> dict:
    """Each state entry: its placements if a DTensor, else ("plain",
    shape); by param name (param-keyed entries) or by key."""
    name_of = {id(p): k for k, p in params.items()}

    def one(v):
        if isinstance(v, DTensor):
            return tuple(v.placements)
        return ("plain", tuple(v.shape)) if isinstance(v, torch.Tensor) \
            else None

    out = {}
    for key, value in optimizer.state.items():
        if isinstance(value, dict):
            out[name_of[id(key)]] = {k: one(v) for k, v in value.items()}
        else:
            out[key] = one(value)
    return out


def _port_train(name, inputs, config=None):
    """Three steps of the tiny Llama: losses, whole params, placements,
    state layout. Without ``config`` the unsharded run."""
    mesh = config is not None
    res = auto_accelerate(
        llama_loss_fn(TINY),
        lambda seed, device: params_from_jax(inputs["params"], device),
        _factory(name, inputs),
        Strategy(mesh=config or MeshConfig(), compute_dtype="float32",
                 remat="none"),
        device="cpu",
        param_logical_axes=llama_logical_axes(TINY) if mesh else None)
    state, losses = res.state, []
    wsam = (make_wsam_step_fn(llama_loss_fn(TINY), state.optimizer, LR)
            if name == "wsam" else None)
    for tokens in inputs["tokens"]:
        batch = {"tokens": _rows(tokens, config) if mesh else tokens}
        if wsam is not None:
            out = wsam(state.params, {"tokens": torch.as_tensor(
                batch["tokens"])}, None)
            losses.append(global_value(out).item())
        else:
            state, m = res.train_step(state, batch, None)
            losses.append(m["loss"].item())
    return {
        "losses": losses,
        "params": {k: (v.full_tensor() if isinstance(v, DTensor) else v)
                   .detach().clone() for k, v in state.params.items()},
        "placements": {k: tuple(v.placements) if isinstance(v, DTensor)
                       else None for k, v in state.params.items()},
        "local_shapes": {k: tuple((v.to_local() if isinstance(v, DTensor)
                                   else v).shape)
                         for k, v in state.params.items()},
        "layout": _layout(state.optimizer, state.params),
        "declared": steps_on_mesh(state.optimizer),
    }


def _alone(name, grads, params_np, config=None):
    """The optimizer alone over the tiny Llama's tree (DTensors placed by
    its logical axes under ``config``, plain tensors without): three
    steps on ``grads``; the whole params and state afterwards, and the
    grads' norm at each step."""
    axes = llama_logical_axes(TINY)
    dm = (accelerate_lib.build_mesh(config).device_mesh
          if config is not None else None)

    def place(x, name):
        t = torch.tensor(x)
        return t if dm is None else distribute_logical(t, axes[name], dm)

    params = {k: place(v, k).requires_grad_() for k, v in params_np.items()}
    opt = _factory(name)([(k, params[k]) for k in tree_order(params)])
    norms = []
    for step in grads:
        for k, p in params.items():
            p.grad = place(step[k], k)
        norms.append(float(global_norm([params[k].grad
                                        for k in tree_order(params)])))
        opt.step()

    def whole(v):
        v = v.full_tensor() if isinstance(v, DTensor) else v
        return v.detach().clone() if isinstance(v, torch.Tensor) else v

    # state_dict(): OffloadAdam's host shards come back placed as their
    # params; its indices follow the param groups (muP's are several)
    name_of = {id(p): k for k, p in params.items()}
    order = [name_of[id(p)] for g in opt.param_groups for p in g["params"]]
    state = {(order[key] if isinstance(key, int) else key):
             ({k: whole(v) for k, v in value.items()}
              if isinstance(value, dict) else whole(value))
             for key, value in opt.state_dict()["state"].items()}
    return {"params": {k: whole(v) for k, v in params.items()},
            "state": state, "norms": norms}


def _reuse_meshes() -> None:
    """In a worker: one mesh (a DeviceMesh and its gloo groups) per mesh
    config, reused by every case, instead of new process groups for each
    of the many ``auto_accelerate`` calls."""
    made = {}

    def build(config=None):
        config = config or MeshConfig()
        if config not in made:
            made[config] = build_mesh(config)
        return made[config]

    accelerate_lib.build_mesh = build


def _gloo_worker(rank, store, out_dir, inputs):
    # a crash (SIGSEGV) prints this rank's stack to its stderr
    faulthandler.enable()
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(N)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=N)
    _reuse_meshes()
    try:
        got = {}
        flat = {k: v.numpy() for k, v in
                params_from_jax(inputs["params"]).items()}
        for mesh_name, kw in MESHES.items():
            config = MeshConfig(**kw)
            for name in OPTIMIZERS:
                got["train", name, mesh_name] = _port_train(name, inputs,
                                                            config)
            for name in ALONE:
                got["alone", name, mesh_name] = _alone(
                    name, inputs["grads"][name], flat, config)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Spawn the 4 ranks once; (inputs, each rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh_optim_gloo")
    inputs = _inputs()
    mp = torch.multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_gloo_worker,
                        args=(r, tmp / "store", str(tmp), inputs))
             for r in range(N)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + GLOO_DEADLINE_S
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not hung, (f"gloo ranks {hung} still running after "
                      f"{GLOO_DEADLINE_S} s; killed")
    assert [p.exitcode for p in procs] == [0] * N
    return inputs, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                    for r in range(N)]


# ------------------------------------------------------------- JAX side


@pytest.fixture(autouse=True)
def _restore_global_mesh(monkeypatch):
    """The JAX side sets its process-global mesh; put it back after each
    test so other test files in this process see what they expect."""
    from dlrover_tpu.parallel import mesh

    monkeypatch.setattr(mesh, "_global_mesh", mesh._global_mesh)


def _jax_tx(name):
    import optax

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.ops import fused_optim as jfo
    from dlrover_tpu.optimizers import adam8bit as jax_adam8bit
    from dlrover_tpu.optimizers import agd as jax_agd
    from dlrover_tpu.optimizers import group_adagrad as jax_group_adagrad
    from dlrover_tpu.optimizers import group_adam as jax_group_adam
    from dlrover_tpu.optimizers import mup_adam as jax_mup_adam

    jc = JaxConfig(**dataclasses.asdict(TINY))
    return {
        "fused_adamw32": lambda: jfo.fused_adamw(LR),
        "fused_adamw32_clip": lambda: jfo.fused_adamw(LR, clip_norm=CLIP),
        "fused_adamw8": lambda: jfo.fused_adamw(LR, bits=8),
        "adam8bit": lambda: jax_adam8bit(LR),
        "agd": lambda: jax_agd(LR),
        "group_adam": lambda: jax_group_adam(LR),
        "group_adagrad": lambda: jax_group_adagrad(LR),
        "mup_adam": lambda: jax_mup_adam(LR, jax_axes(jc), MUP_WIDTH),
    }.get(name, lambda: optax.adamw(LR, weight_decay=0.0))()


def _jax_train(name, inputs, mesh_kw):
    """Three steps on 4 virtual devices: (losses, params by name)."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxConfig
    from dlrover_tpu.models.llama import llama_logical_axes as jax_axes
    from dlrover_tpu.models.llama import llama_loss_fn as jax_loss
    from dlrover_tpu.optimizers import make_wsam_step_fn as jax_wsam
    from dlrover_tpu.optimizers.offload import OffloadAdam as JaxOffload
    from dlrover_tpu.parallel.accelerate import auto_accelerate as jax_acc
    from dlrover_tpu.parallel.mesh import MeshConfig as JaxMesh
    from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy

    jc = JaxConfig(**dataclasses.asdict(TINY))
    tx = _jax_tx(name)
    res = jax_acc(
        jax_loss(jc), lambda r: jax.tree.map(jnp.asarray, inputs["params"]),
        tx, jax_axes(jc),
        strategy=JaxStrategy(mesh=JaxMesh(**mesh_kw), compute_dtype="float32",
                             remat="none", donate=False),
        devices=jax.devices()[:N])
    state, params, losses = res.state, res.state.params, []
    batches = [{"tokens": jnp.asarray(t)} for t in inputs["tokens"]]
    if name == "wsam":
        step = jax.jit(jax_wsam(jax_loss(jc), tx, LR))
        opt_state = state.opt_state
        for i, batch in enumerate(batches):
            params, opt_state, out = step(params, opt_state, batch,
                                          jax.random.key(i))
            losses.append(float(out))
    elif name == "offload_adam":
        grad = jax.jit(jax.value_and_grad(jax_loss(jc)))
        opt = JaxOffload(LR)
        opt_state = opt.init(params)
        for i, batch in enumerate(batches):
            loss, grads = grad(params, batch, jax.random.key(i))
            params, opt_state = opt.step(params, grads, opt_state)
            losses.append(float(loss))
    else:
        for i, batch in enumerate(batches):
            state, m = res.train_step(state, batch, jax.random.key(i))
            losses.append(float(m["loss"]))
        params = state.params
    return losses, params_from_jax(jax.tree.map(np.asarray, params))


def _assert_f32_params(params, ref):
    diffs = torch.cat([(params[k] - ref[k]).abs().flatten() for k in ref])
    assert diffs.median().item() < 1e-6
    assert diffs.quantile(0.99).item() < 2e-3 * LR
    assert diffs.max().item() < 0.25 * LR


def _assert_8bit_params(params, ref, start):
    moved = max(max((ref[k] - start[k]).abs().max().item() for k in ref),
                1e-12)
    diffs = torch.cat([(params[k] - ref[k]).abs().flatten() for k in ref])
    assert diffs.median().item() < 1e-6
    assert diffs.max().item() / moved <= 0.1


# ------------------------------------------------------------ assertions

CASES = [(o, m) for m in MESHES for o in OPTIMIZERS]


@pytest.fixture(scope="module")
def unsharded(gloo_run):
    """The port's unsharded run of each optimizer, made once."""
    inputs, _ = gloo_run
    return {name: _port_train(name, inputs) for name in OPTIMIZERS}


@pytest.mark.parametrize("name,mesh_name", CASES,
                         ids=[f"{o}-{m}" for o, m in CASES])
def test_optimizer_on_a_mesh_matches_jax_mesh(gloo_run, unsharded, name,
                                              mesh_name):
    inputs, saved = gloo_run
    ref_losses, ref_params = _jax_train(name, inputs, MESHES[mesh_name])
    start = params_from_jax(inputs["params"])
    for got in saved:
        got = got["train", name, mesh_name]
        assert got["declared"]
        np.testing.assert_allclose(got["losses"], ref_losses, atol=1e-5)
        np.testing.assert_allclose(got["losses"], unsharded[name]["losses"],
                                   atol=1e-5)
        if name in EIGHT_BIT:
            _assert_8bit_params(got["params"], ref_params, start)
        else:
            _assert_f32_params(got["params"], ref_params)


@pytest.mark.parametrize("name,mesh_name", CASES,
                         ids=[f"{o}-{m}" for o, m in CASES])
def test_state_is_laid_out_as_jax_lays_it(gloo_run, name, mesh_name):
    """Param-shaped moments are DTensors placed as their params; every
    other state entry is a plain tensor of the global layout (the flat
    rows of every leaf's global blocks, a code row per global block, a
    count per global row), the same shape on every rank."""
    inputs, saved = gloo_run
    flat = params_from_jax(inputs["params"])
    meta = flatten_meta([flat[k] for k in tree_order(flat)])
    rows = dict(zip(tree_order(flat), meta.rows))
    for got in saved:
        got = got["train", name, mesh_name]
        placed, layout = got["placements"], got["layout"]
        assert all(pl is not None for pl in placed.values())
        for key, entry in layout.items():
            if key in placed:  # a param's own state
                for k, lay in entry.items():
                    if k in ("mu_q", "nu_q"):
                        assert lay == ("plain", (rows[key], 256))
                    elif k in ("mu_scale", "nu_scale"):
                        assert lay == ("plain", (rows[key], 1))
                    elif k == "steps":
                        shape = tuple(flat[key].shape)
                        assert lay == ("plain", shape[:1]
                                       + (1,) * (len(shape) - 1))
                    elif k == "step":
                        continue  # torch Adam's count
                    elif name == "offload_adam":  # this rank's, on the host
                        assert lay == ("plain", got["local_shapes"][key])
                    else:  # mu, nu, accum, exp_avg, exp_avg_sq
                        assert lay == placed[key], (key, k, lay)
            elif key in ("mu", "nu", "mu_q", "nu_q"):
                assert lay_shape(layout[key]) == (meta.total_rows, 256)
            elif key in ("mu_scale", "nu_scale"):
                assert lay_shape(layout[key]) == (meta.total_rows, 1)


def lay_shape(lay):
    assert lay[0] == "plain"
    return lay[1]


ALONE_CASES = [(o, m) for m in MESHES for o in ALONE]


@pytest.mark.parametrize("name,mesh_name", ALONE_CASES,
                         ids=[f"{o}-{m}" for o, m in ALONE_CASES])
def test_mesh_step_is_the_unsharded_step_bit_for_bit(gloo_run, name,
                                                     mesh_name):
    inputs, saved = gloo_run
    flat = {k: v.numpy() for k, v in
            params_from_jax(inputs["params"]).items()}
    ref = _alone(name, inputs["grads"][name], flat)
    for got in saved:
        got = got["alone", name, mesh_name]
        for k, v in ref["params"].items():
            assert torch.equal(got["params"][k], v), k
        assert got["state"].keys() == ref["state"].keys()
        for key, value in ref["state"].items():
            if isinstance(value, dict):
                for k, v in value.items():
                    assert torch.equal(got["state"][key][k], v), (key, k)
            elif isinstance(value, torch.Tensor):
                assert torch.equal(got["state"][key], value), key
            else:
                assert got["state"][key] == value, key
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-6)


def test_the_clip_case_crosses_clip_norm(gloo_run):
    """Its steps' global norms sit above, below and above ``clip_norm``,
    on every mesh as without one."""
    _, saved = gloo_run
    for got in saved:
        for mesh_name in MESHES:
            norms = got["alone", "fused_adamw32_clip", mesh_name]["norms"]
            assert [n > CLIP for n in norms] == [True, False, True]


@pytest.mark.parametrize("mesh_name", ["fsdp4", "fsdp2-tensor2"])
def test_group_adam_counts_a_row_touched_on_one_rank_only(gloo_run,
                                                          mesh_name):
    """Embedding rows 0-63 have nonzero grads only in the columns of the
    first fsdp rank; every rank counts them as touched (their count
    reaches 3), rows 64-127 stay at 0, and layer 1 of w_up too."""
    _, saved = gloo_run
    for got in saved:
        steps = got["alone", "group_adam", mesh_name]["state"]
        embed = steps["embed"]["steps"].flatten()
        assert embed[:64].tolist() == [STEPS] * 64
        assert embed[64:128].tolist() == [0] * 64
        assert embed[128:].tolist() == [STEPS] * 128
        assert steps["layers.w_up"]["steps"].flatten().tolist() == [STEPS, 0]


@pytest.mark.parametrize("optimizer", [FusedAdamW, Adam8bit, AGD, GroupAdam,
                                       GroupAdagrad, OffloadAdam])
def test_the_port_optimizers_declare_a_mesh_step(optimizer):
    assert optimizer.steps_on_mesh is True
