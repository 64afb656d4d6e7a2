"""The port's RL stack (dlrover_tpu_torch/rl) held against the JAX
package's (dlrover_tpu/rl) on the CPU.

``ppo_utils``' functions on the same seeded inputs within 1e-6 of the
largest value; the replay buffer's batches equal; one ``PPOTrainer``
update and one ``LMPPOTrainer`` iteration (greedy rollouts, temperature
0) from the same initial params: the experience within 1e-5, the stats
within 1e-4 and each param's change over the Adam steps within 1% of
the learning rate per step (optax.adam and torch's Adam at the same
settings); the role engine's raises for
what is not ported; the example twin learns its bandit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dlrover_tpu import rl as jrl
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.rl.generation import GenerateConfig as JaxGenerateConfig
from dlrover_tpu_torch import rl as trl
from dlrover_tpu_torch.models import llama as port_llama
from dlrover_tpu_torch.models import params_from_jax
from dlrover_tpu_torch.rl.generation import GenerateConfig

UTIL_TOL = 1e-6
# an Adam step moves each element by at most lr (|m_hat / sqrt(v_hat)| <= 1
# on the first step): each param's change over the run agrees with the
# JAX package's within 1% of lr per step
ADAM_STEP_TOL = 1e-2


def close(got, want, what, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def ppo_inputs(seed=0, B=3, T=7):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, T), np.float32)
    mask[0, :2] = 0.0          # an LM-style prompt prefix
    mask[1, 5:] = 0.0          # terminated early
    mask[2, :] = 0.0           # nothing valid
    return {
        "logits": rs.randn(B, T, 11).astype(np.float32),
        "actions": rs.randint(0, 11, (B, T)).astype(np.int32),
        "logprobs": (rs.randn(B, T) * 0.3 - 2).astype(np.float32),
        "ref": (rs.randn(B, T) * 0.3 - 2).astype(np.float32),
        "old": (rs.randn(B, T) * 0.3 - 2).astype(np.float32),
        "values": rs.randn(B, T).astype(np.float32),
        "old_values": rs.randn(B, T).astype(np.float32),
        "rewards": rs.randn(B, T).astype(np.float32),
        "scores": rs.randn(B).astype(np.float32),
        "mask": mask,
    }


def t(x):
    return torch.as_tensor(x)


def close_steps(got, start, want, want_start, what, lr, steps):
    """The change of a param over ``steps`` Adam steps against the JAX
    package's change from the same start."""
    delta = got.detach().numpy() - np.asarray(start)
    want_delta = np.asarray(want) - np.asarray(want_start)
    err = float(np.abs(delta - want_delta).max())
    assert err <= ADAM_STEP_TOL * lr * steps, f"{what}: {err}"
    assert float(np.abs(want_delta).max()) > 0, f"{what} did not move"


# ============================================================= ppo_utils


def test_logprobs_from_logits_matches_jax():
    x = ppo_inputs()
    close(trl.logprobs_from_logits(t(x["logits"]), t(x["actions"])),
          jrl.logprobs_from_logits(jnp.asarray(x["logits"]),
                                   jnp.asarray(x["actions"])),
          "logprobs", UTIL_TOL)


@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_kl_and_rewards_match_jax(kl_coef):
    x = ppo_inputs()
    close(trl.kl_penalty(t(x["logprobs"]), t(x["ref"]), kl_coef),
          jrl.kl_penalty(jnp.asarray(x["logprobs"]), jnp.asarray(x["ref"]),
                         kl_coef), "kl", UTIL_TOL)
    got = trl.rewards_with_kl(t(x["scores"]), t(x["logprobs"]), t(x["ref"]),
                              t(x["mask"]), kl_coef)
    want = jrl.rewards_with_kl(jnp.asarray(x["scores"]),
                               jnp.asarray(x["logprobs"]),
                               jnp.asarray(x["ref"]), jnp.asarray(x["mask"]),
                               kl_coef)
    close(got, want, "rewards", UTIL_TOL)
    # the score lands on the last positionally valid token; a row with
    # none gets nothing
    if kl_coef == 0.0:
        assert float(got[0, 6]) == pytest.approx(float(x["scores"][0]))
        assert float(got[1, 4]) == pytest.approx(float(x["scores"][1]))
        assert float(got[:2].abs().sum()) == pytest.approx(
            float(np.abs(x["scores"][:2]).sum()))
    assert float(got[2].abs().sum()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_whiten_matches_jax(masked):
    x = ppo_inputs()
    mask = x["mask"] if masked else None
    close(trl.whiten(t(x["values"] * 3 + 5),
                     None if mask is None else t(mask)),
          jrl.whiten(jnp.asarray(x["values"] * 3 + 5),
                     None if mask is None else jnp.asarray(mask)),
          "whiten", UTIL_TOL)


@pytest.mark.parametrize("whitening", [False, True])
@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9)])
def test_gae_matches_jax(whitening, gamma, lam):
    x = ppo_inputs()
    adv, ret = trl.gae_advantages_and_returns(
        t(x["values"]), t(x["rewards"]), t(x["mask"]), gamma, lam,
        whitening)
    jadv, jret = jrl.gae_advantages_and_returns(
        jnp.asarray(x["values"]), jnp.asarray(x["rewards"]),
        jnp.asarray(x["mask"]), gamma, lam, whitening)
    close(adv, jadv, "advantages", UTIL_TOL)
    close(ret, jret, "returns", UTIL_TOL)
    assert not adv.requires_grad and not ret.requires_grad


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
def test_ppo_loss_matches_jax(entropy_coef):
    x = ppo_inputs()
    args = ("logprobs", "values", "old", "old_values", "rewards", "values",
            "mask")
    total, stats = trl.ppo_loss(*(t(x[k]) for k in args),
                                entropy_coef=entropy_coef,
                                logits=t(x["logits"]))
    jtotal, jstats = jrl.ppo_loss(*(jnp.asarray(x[k]) for k in args),
                                  entropy_coef=entropy_coef,
                                  logits=jnp.asarray(x["logits"]))
    close(total, jtotal, "total", UTIL_TOL)
    assert set(stats) == set(jstats)
    for key in stats:
        close(stats[key], jstats[key], key, UTIL_TOL)


def test_replay_buffer_is_the_jax_copy():
    samples = {"obs": np.arange(12).reshape(6, 2), "r": np.arange(6.0)}
    got, want = trl.ReplayBuffer(), jrl.ReplayBuffer()
    got.add_samples(samples)
    want.add_samples(samples)
    for a, b in zip(got.batches(4, seed=3), want.batches(4, seed=3)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="missing"):
        trl.ReplayBuffer(element_keys=["a", "b"]).add_sample({"a": 1})


# ========================================================== model engine


def test_model_engine_raises_for_strategies_and_reshard():
    spec = trl.ModelSpec(lambda seed: {"w": torch.zeros(2)},
                         lambda p, x: x, strategy=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        trl.ModelEngine({"actor": spec}, device="cpu")
    plain = trl.ModelSpec(lambda seed: {"w": torch.zeros(2)},
                          lambda p, x: x @ p["w"])
    engine = trl.ModelEngine({"actor": plain}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        engine.reshard("actor", object())
    with pytest.raises(ValueError, match="optimizer"):
        trl.ModelEngine({"actor": trl.ModelSpec(
            lambda seed: {"w": torch.zeros(2)}, lambda p, x: x,
            trainable=True)}, device="cpu")


def test_model_engine_roles(monkeypatch):
    """Seeds reach ``init_fn``; a trainable role's params require grad
    and its optimizer is built over them; ``apply`` runs without grad;
    ``sync_ref_from_actor`` copies (a later actor step leaves the ref);
    the default device raises without CUDA."""
    def init(seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(3, 2, generator=g)}

    def apply(p, x):
        return x @ p["w"]

    engine = trl.ModelEngine({
        "actor": trl.ModelSpec(init, apply, trainable=True,
                               optimizer=lambda p: torch.optim.SGD(
                                   p.values(), lr=0.5)),
        "ref": trl.ModelSpec(init, apply),
    }, seed=3, device="cpu")
    assert engine.actor["w"].requires_grad
    assert not torch.equal(engine.actor["w"], engine.ref["w"])
    out = engine.apply("actor", torch.ones(1, 3))
    assert not out.requires_grad
    engine.sync_ref_from_actor()
    assert torch.equal(engine.actor["w"], engine.ref["w"])
    (engine.actor["w"].sum()).backward()
    engine.optimizer("actor").step()
    assert not torch.equal(engine.actor["w"], engine.ref["w"])
    again = trl.ModelEngine({"ref": trl.ModelSpec(init, apply)}, seed=3,
                            device="cpu")
    assert torch.equal(again.ref["w"], init(int(torch.randint(
        0, 2 ** 62, (), generator=torch.Generator().manual_seed(3))))["w"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        trl.ModelEngine({"ref": trl.ModelSpec(init, apply)})


# ============================================================= PPOTrainer


N_ACTIONS, OBS_DIM, HIDDEN = 4, 6, 32


def bandit_params():
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    return ({"w1": jax.random.normal(k1, (OBS_DIM, HIDDEN)) * 0.1,
             "w2": jax.random.normal(k2, (HIDDEN, N_ACTIONS)) * 0.1},
            {"w": jax.random.normal(k3, (OBS_DIM, 1)) * 0.1})


def as_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_ppo_update_matches_jax():
    """JAX's experience on the bandit, copied into both trainers' buffers
    (actions are drawn from different generators), then two epochs of
    updates each: the stats and both roles' params after the Adam steps
    as the JAX trainer's."""
    actor0, critic0 = bandit_params()

    def jax_engine():
        return jrl.ModelEngine({
            "actor": jrl.ModelSpec(
                lambda rng: actor0,
                lambda p, o: jnp.tanh(o @ p["w1"]) @ p["w2"],
                trainable=True, optimizer=optax.adam(3e-3)),
            "critic": jrl.ModelSpec(
                lambda rng: critic0, lambda p, o: (o @ p["w"])[..., 0],
                trainable=True, optimizer=optax.adam(3e-3)),
            "ref": jrl.ModelSpec(
                lambda rng: actor0,
                lambda p, o: jnp.tanh(o @ p["w1"]) @ p["w2"]),
        })

    def adam(p):
        return torch.optim.Adam(p.values(), lr=3e-3)

    port_engine = trl.ModelEngine({
        "actor": trl.ModelSpec(
            lambda seed: as_port(actor0),
            lambda p, o: torch.tanh(o @ p["w1"]) @ p["w2"],
            trainable=True, optimizer=adam),
        "critic": trl.ModelSpec(
            lambda seed: as_port(critic0), lambda p, o: (o @ p["w"])[..., 0],
            trainable=True, optimizer=adam),
        "ref": trl.ModelSpec(
            lambda seed: as_port(actor0),
            lambda p, o: torch.tanh(o @ p["w1"]) @ p["w2"]),
    }, device="cpu")
    cfg = dict(ppo_epochs=2, train_batch_size=8, kl_coef=0.05)
    jt = jrl.PPOTrainer(jax_engine(), jrl.PPOConfig(**cfg),
                        score_fn=lambda o, a: jnp.mean(
                            (a == jnp.argmax(o[..., :N_ACTIONS], -1))
                            .astype(jnp.float32), -1))
    tt = trl.PPOTrainer(port_engine, trl.PPOConfig(**cfg),
                        score_fn=lambda o, a: (
                            a == torch.argmax(o[..., :N_ACTIONS], -1))
                        .float().mean(-1))
    obs = np.random.RandomState(0).randn(16, 3, OBS_DIM).astype(np.float32)
    jt.make_experience({"obs": obs})
    tt.make_experience({"obs": obs})
    # the port's own experience is self-consistent
    sample = tt.buffer._samples[0]
    logits = torch.tanh(t(sample["obs"]) @ port_engine.actor["w1"]) \
        @ port_engine.actor["w2"]
    close(t(sample["old_logprobs"]),
          torch.log_softmax(logits.detach(), -1).gather(
              -1, t(sample["actions"])[:, None].long())[:, 0],
          "old logprobs", 1e-6)
    tt.buffer.reset()
    tt.buffer.add_samples(list(jt.buffer._samples))
    jstats = jt.rl_training()
    tstats = tt.rl_training()
    for key in jstats:
        close(tstats[key], jstats[key], key, 1e-4)
    for role, start in (("actor", actor0), ("critic", critic0)):
        for name, w in jt.engine.params[role].items():
            close_steps(port_engine.params[role][name], start[name], w,
                        start[name], f"{role}.{name}", 3e-3, 2)


# =========================================================== LMPPOTrainer


def lm_models(temperature):
    fields = dataclasses.asdict(port_llama.PRESETS["tiny"])
    jc, tc = jax_llama.LlamaConfig(**fields), port_llama.LlamaConfig(**fields)
    actor = jax_llama.llama_init(jc, jax.random.key(0))
    k = jax.random.key(1)
    critic = {"w": jax.random.normal(k, (jc.dim, 1)) * 0.02,
              "emb": jax.random.normal(k, (jc.vocab_size, jc.dim)) * 0.02}
    jengine = jrl.ModelEngine({
        "actor": jrl.ModelSpec(
            lambda rng: actor,
            lambda p, tok: jax_llama.llama_apply(jc, p, tok),
            trainable=True, optimizer=optax.adam(1e-4)),
        "critic": jrl.ModelSpec(
            lambda rng: critic, lambda p, tok: (p["emb"][tok] @ p["w"])[..., 0],
            trainable=True, optimizer=optax.adam(1e-3)),
        "ref": jrl.ModelSpec(
            lambda rng: actor,
            lambda p, tok: jax_llama.llama_apply(jc, p, tok)),
    })
    actor_np = jax.tree.map(np.asarray, actor)
    tengine = trl.ModelEngine({
        "actor": trl.ModelSpec(
            lambda seed: params_from_jax(actor_np),
            lambda p, tok: port_llama.llama_apply(tc, p, tok),
            trainable=True, optimizer=lambda p: torch.optim.Adam(
                p.values(), lr=1e-4)),
        "critic": trl.ModelSpec(
            lambda seed: as_port(critic),
            lambda p, tok: (F.embedding(tok.long(), p["emb"]) @ p["w"])[..., 0],
            trainable=True, optimizer=lambda p: torch.optim.Adam(
                p.values(), lr=1e-3)),
        "ref": trl.ModelSpec(
            lambda seed: params_from_jax(actor_np),
            lambda p, tok: port_llama.llama_apply(tc, p, tok)),
    }, device="cpu")
    cfg = dict(ppo_epochs=2, train_batch_size=4)
    jt = jrl.LMPPOTrainer(
        jengine, jrl.PPOConfig(**cfg), llama_config=jc,
        score_fn=lambda seq, m: (np.asarray(seq)[:, -m.shape[1]:] % 2 == 0)
        .mean(axis=1),
        gen=JaxGenerateConfig(max_new_tokens=6, temperature=temperature))
    tt = trl.LMPPOTrainer(
        tengine, trl.PPOConfig(**cfg), llama_config=tc,
        score_fn=lambda seq, m: (seq[:, -m.shape[1]:] % 2 == 0).float()
        .mean(1),
        gen=GenerateConfig(max_new_tokens=6, temperature=temperature))
    return jt, tt


def lm_prompts():
    return {"tokens": np.random.RandomState(5).randint(
        0, 256, (4, 5)).astype(np.int32)}


def test_lm_ppo_iteration_matches_jax_at_temperature_0():
    """One iteration, two epochs of updates: the experience, the stats
    and each param's change from the same start as the JAX trainer's."""
    from dlrover_tpu_torch.models.convert import _by_name

    jt, tt = lm_models(0.0)
    start = {"actor": _by_name(jax.tree.map(np.asarray,
                                            jt.engine.params["actor"])),
             "critic": jax.tree.map(np.asarray, jt.engine.params["critic"])}
    js = jt.make_experience(lm_prompts())
    ts = tt.make_experience(lm_prompts())
    assert ts == pytest.approx(js, abs=1e-6)
    assert len(tt.buffer) == len(jt.buffer) == 4
    for got, want in zip(tt.buffer._samples, jt.buffer._samples):
        for key in ("obs", "actions", "mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          key)
        for key in ("old_logprobs", "old_values", "advantages", "returns"):
            close(got[key], want[key], key, 1e-5)
    jstats = jt.rl_training()
    tstats = tt.rl_training()
    for key in jstats:
        close(tstats[key], jstats[key], key, 1e-4)
    for name, w in jt.engine.params["critic"].items():
        close_steps(tt.engine.params["critic"][name], start["critic"][name],
                    w, start["critic"][name], f"critic.{name}", 1e-3, 2)
    from dlrover_tpu_torch.models.convert import _by_name

    for name, w in _by_name(jt.engine.params["actor"]).items():
        close_steps(tt.engine.params["actor"][name], start["actor"][name], w,
                    start["actor"][name], f"actor.{name}", 1e-4, 2)


def test_lm_ppo_sampled_rollout_is_consistent():
    """At temperature 1: finite stats, the actor moved, and the rollout's
    logprobs equal log_softmax of the actor's teacher-forced logits at
    the sampled tokens (what ``make_experience`` stores)."""
    _, tt = lm_models(1.0)
    before = {k: v.detach().clone() for k, v in tt.engine.actor.items()}
    rollouts = []
    generate = tt.backend.generate
    tt.backend.generate = lambda *a: rollouts.append(generate(*a)) or \
        rollouts[-1]
    tt.make_experience(lm_prompts())
    res = rollouts[0]
    stored = np.stack([s["old_logprobs"] for s in tt.buffer._samples])
    close(t(stored[:, 4:]), res.logprobs, "rollout logprobs", 1e-5)
    stats = tt.rl_training()
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert any(not torch.equal(before[k], v)
               for k, v in tt.engine.actor.items())


def test_lm_ppo_advantages_carry_reward():
    """A nonzero sequence score reaches the advantages (the score lands
    on the last positionally valid token)."""
    fields = dataclasses.asdict(port_llama.PRESETS["tiny"])
    tc = port_llama.LlamaConfig(**fields)
    engine = trl.ModelEngine({
        "actor": trl.ModelSpec(
            lambda seed: port_llama.llama_init(tc, seed, device="cpu"),
            lambda p, tok: port_llama.llama_apply(tc, p, tok),
            trainable=True,
            optimizer=lambda p: torch.optim.Adam(p.values(), lr=1e-4)),
        "critic": trl.ModelSpec(
            lambda seed: {"emb": torch.zeros(tc.vocab_size)},
            lambda p, tok: p["emb"][tok.long()], trainable=True,
            optimizer=lambda p: torch.optim.Adam(p.values(), lr=1e-3)),
    }, device="cpu")
    trainer = trl.LMPPOTrainer(
        engine, trl.PPOConfig(whiten_advantages=False, kl_coef=0.0),
        llama_config=tc, score_fn=lambda seq, m: torch.ones(seq.shape[0]),
        gen=GenerateConfig(max_new_tokens=4, temperature=1.0))
    trainer.make_experience(lm_prompts())
    adv = np.stack([s["advantages"] for s in trainer.buffer._samples])
    assert np.abs(adv).max() > 0.1


def test_example_twin_learns_the_bandit(capsys):
    from dlrover_tpu_torch.examples import ppo_rlhf

    final = ppo_rlhf.main(["--iterations", "15", "--batch", "16"],
                          device="cpu")
    assert final > 0.6, capsys.readouterr().out
    assert "final mean score" in capsys.readouterr().out
