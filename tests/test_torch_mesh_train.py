"""Mesh-placed training on the CPU: train steps, the elastic restore and the
SpotTrainer's relaunch onto a mesh, against the single process and JAX.

* Three train steps of glm4-9b's smoke config (float32, the JAX package's
  init carried across) on 8 gloo ranks at ``(2, 4)``: the losses within
  1e-5 relative of the single-process port's and of JAX's
  ``make_train_step``, and every parameter within 1e-4 of both.
* The elastic scenario through ``repro_torch.launch.elastic_restart`` at its
  defaults (2 ranks on ``(2,)``, save, 8 ranks on ``(4, 2)``, ``restore(...,
  shardings=)``, 3 steps each) in float32: the 6 losses within 1e-4 relative
  of JAX's 6 unsharded steps of the same smoke config, init (the port's
  ``init_params`` draws JAX's stream) and data.  GSPMD gives the JAX
  package's mesh run the same math up to rounding.
* ``SpotTrainer(relaunch_shardings=)`` on 4 ranks at ``(2, 2)`` over
  ``tests/train/test_spot_trainer.py``'s one-preemption trace (float32,
  async writes): the report equals the single-process port's, the losses
  within 1e-4 relative; a torn leaf raises ``CheckpointCorruptionError`` on
  every rank; a restore with the shardings gives the state's placements.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_mesh_ranks as mesh_ranks
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.data import TokenStream as JaxTokenStream
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import get_smoke_config
from repro_torch.core import SimParams, step_trace
from repro_torch.data import TokenStream
from repro_torch.launch import elastic_restart as E
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.ranks import run_ranks
from repro_torch.train.spot_trainer import SpotTrainer, SpotTrainerConfig
from repro_torch.train.steps import make_train_step

LR, BLOCK = 1e-3, 8
LOSS_RTOL, PARAM_TOL, ELASTIC_RTOL = 1e-5, 1e-4, 1e-4


def f32_configs(arch="glm4-9b"):
    return (dataclasses.replace(jax_get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def jax_steps(jcfg, jparams, batches, block, remat=False):
    """JAX's ``make_train_step`` over ``batches``, with the JAX package's default
    32-bit types (the JAX engine backend turns x64 on for the process)."""
    opt = JaxAdamWConfig(lr=LR, moment_dtype="float32")
    with jax.enable_x64(False):
        step = jax.jit(jax_make_train_step(jcfg, opt, remat=remat, q_block=block, kv_block=block))
        params, state, losses = jparams, jax_adamw_init(jparams, opt), []
        for b in batches:
            params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    return losses, params


def test_three_placed_train_steps_match_the_single_process_and_jax():
    jcfg, cfg = f32_configs()
    with jax.enable_x64(False):
        jparams = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "case.pt"
        torch.save({"cfg": cfg, "params": jparams, "batches": batches, "block": BLOCK, "lr": LR, "remat": True}, path)
        ranks = run_ranks(mesh_ranks.train_rank, 8, str(path), (2, 4), 3)
    got = ranks[0]
    assert all(r["losses"] == got["losses"] for r in ranks)
    # the single process
    step = make_train_step(cfg, AdamWConfig(lr=LR, moment_dtype="float32"), remat=True, q_block=BLOCK,
                           kv_block=BLOCK)
    params = from_jax(cfg, jparams, "cpu")
    state, losses = adamw_init(params, AdamWConfig(lr=LR)), []
    for b in batches:
        params, state, m = step(params, state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    jlosses, jfinal = jax_steps(jcfg, jparams, batches, BLOCK, remat=True)
    for want_losses, want_params in ((losses, tree_lib.leaves(params)),
                                     (jlosses, [torch.from_numpy(np.asarray(x)) for x in jax.tree.leaves(jfinal)])):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        for x, w in zip(tree_lib.leaves(got["params"]), want_params):
            assert float((x - w).abs().max()) <= PARAM_TOL
    assert "Shard(dim=0)" in got["placements"][0]  # the state stayed placed through the steps


def test_elastic_restore_onto_another_mesh_matches_jax(tmp_path):
    run = E.ElasticRun(ckpt_dir=str(tmp_path / "ckpt"), dtype="float32", device="cpu")
    first, second = E.run_both(run)
    assert [len(first), len(second)] == [2, 8]
    for ranks in (first, second):
        assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    got = first[0]["losses"] + second[0]["losses"]
    assert second[0]["step"] == 3
    # embed.tokens (vocab, embed): the vocab over the 2-wide model axis, whole over data
    assert second[0]["restored_placements"] == "(Replicate(), Shard(dim=0))"
    jcfg, _ = f32_configs()
    with jax.enable_x64(False):  # the JAX package's default types, whatever another test set
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        data = JaxTokenStream(vocab_size=jcfg.vocab_size, batch=run.batch, seq_len=run.seq, seed=0)
        batches = [{k: np.asarray(v) for k, v in next(data).items()} for _ in range(2 * run.steps)]
    want, _ = jax_steps(jcfg, jparams, batches, run.block)
    np.testing.assert_allclose(got, want, rtol=ELASTIC_RTOL)


def spot_case():
    _, cfg = f32_configs()
    return {
        "cfg": cfg, "lr": LR, "block": BLOCK,
        "trace": step_trace([(0.0, 0.40), (3200.0, 1.00), (4000.0, 0.40)]),
        "data": {"vocab_size": cfg.vocab_size, "batch": 2, "seq_len": 32, "seed": 7},
        "tcfg": {"a_bid": 0.5, "max_steps": 24, "step_time_s": 300.0, "sim": SimParams(t_c=300.0, t_r=600.0),
                 "async_io": True},
    }


def test_spot_trainer_relaunches_onto_the_mesh_with_the_single_process_report(tmp_path):
    case = spot_case()
    cfg, opt = case["cfg"], AdamWConfig(lr=LR, moment_dtype="float32")

    def init():
        params = T.init_params(cfg, 0, device="cpu")
        return params, adamw_init(params, opt)

    want = SpotTrainer(SpotTrainerConfig(ckpt_dir=str(tmp_path / "one"), **case["tcfg"]),
                       train_step=make_train_step(cfg, opt, remat=False, q_block=BLOCK, kv_block=BLOCK),
                       init_params=init, data=TokenStream(device="cpu", **case["data"]),
                       trace=case["trace"]).run()
    assert want.n_preemptions == 1 and want.n_restores == 1 and want.completed
    case["tcfg"]["ckpt_dir"] = str(tmp_path / "mesh")
    path = tmp_path / "case.pt"
    torch.save(case, path)
    ranks = run_ranks(mesh_ranks.trainer_rank, 4, str(path), (2, 2))
    want = dataclasses.asdict(want)
    for r in ranks:
        got = r["report"]
        np.testing.assert_allclose(got.pop("losses"), want["losses"], rtol=1e-4)
        assert {k: v for k, v in got.items() if k != "straggler_events"} == {
            k: v for k, v in want.items() if k not in ("losses", "straggler_events")}
        assert r["corrupt_raised"] and all(r["restored_placements_match"])
