"""Placed serving on the CPU: ``prefill`` and ``decode_step`` on DTensor-placed parameters
and caches for all six families, against the single process and against JAX.

The smoke configs of glm4-9b (dense), internvl2-1b (VLM), arctic-480b (MoE),
whisper-large-v3 (enc-dec), recurrentgemma-9b (hybrid) and falcon-mamba-7b
(SSM) in float32, the JAX package's init carried across (``from_jax``), a
prompt of 8 x 24 tokens from a seed (random ``frames`` / ``vision_embeds`` as
``tests/test_torch_models.py`` makes them), on 8 gloo ranks at ``(2, 4)``
``data x model`` and ``(2, 2, 2)`` ``pod x data x model``: the parameters
placed by ``shard_params`` (``place(..., copy=False)``: each rank's shards
views of the whole leaves where they can be, checked against ``place``'s
copies), the prompt by ``BATCH_AXES``.  Prefill, then
``DECODE_STEPS`` decode steps, each fed the JAX run's greedy token.  Every
step's logits lie within 1e-4 of the single-process port's and of JAX's
``prefill`` / ``decode_step`` (jitted; the hybrid's windowed prefill through
the TPU kernel in interpret mode, as ``tests/test_torch_models.py`` runs it).
The hybrid's prompt (24) is longer than its window (16): the placed prefill
rolls the window cache and decode wraps it.

Also: glm4-9b with the ``sp_kv`` rule (``kv_seq`` on ``model``: the cache
split along its slots, SP decode's merge on each rank's slice); arctic-480b
with ``moe_impl="ep"`` (the explicit EP call on the placed shards); the
placed cache's placements after prefill and after decode equal those of
``shard_params`` over ``cache_axes``; ``loss_fn`` and its gradient placed for
the MoE (both ways), the enc-dec and the VLM, held as
``tests/test_torch_mesh.py`` holds the others (the loss within 1e-5
relative, each leaf's gradient within 1e-4 of its largest reference
gradient); and a mutation: the MoE's capacity positions counted over a
rank's rows at once instead of row by row misses the logits' bound.
"""

import dataclasses
import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import test_torch_placed_serving_ranks as serving_ranks
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.flash_attention import ops as jax_attn_ops
from repro.models import transformer as JT
from repro.train.steps import greedy_sample as jax_greedy_sample
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.parallel.ranks import run_ranks

FAMILIES = {"dense": "glm4-9b", "vlm": "internvl2-1b", "moe": "arctic-480b", "encdec": "whisper-large-v3",
            "hybrid": "recurrentgemma-9b", "ssm": "falcon-mamba-7b"}
MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2)}
BATCH, PROMPT, DECODE_STEPS, BLOCK = 8, 24, 3, 8
LOGITS_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
#: The serving cases: (architecture, rules over the defaults, config changes).
SERVE = {**{f: (a, {}, {}) for f, a in FAMILIES.items()},
         "sp_kv": ("glm4-9b", {"kv_seq": "model"}, {}), "moe_ep": ("arctic-480b", {}, {"moe_impl": "ep"}),
         "moe_mutant": ("arctic-480b", {}, {})}
#: The gradient cases: the families tests/test_torch_mesh.py does not hold placed.
GRADS = {"moe": ("arctic-480b", {}), "moe_ep": ("arctic-480b", {"moe_impl": "ep"}),
         "encdec": ("whisper-large-v3", {}), "vlm": ("internvl2-1b", {})}


@functools.cache
def jax_init(arch):
    cfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))


def configs(arch, changes):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32", **changes)
    return jcfg, dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)


def prompt(cfg, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((BATCH, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal((BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        batch["vision_mask"] = np.arange(PROMPT)[None, :].repeat(BATCH, 0) < cfg.vision_tokens
    return batch


@functools.cache
def references(case):
    """JAX's logits (prefill and each step) and greedy tokens, and the
    single-process port's logits fed the same tokens."""
    arch, _, changes = SERVE[case]
    jcfg, cfg = configs(arch, changes)
    jparams, batch, max_len = jax_init(arch), prompt(cfg), PROMPT + 8
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        if cfg.family == "hybrid":  # the JAX package's block_attention drops keys under a window (ROADMAP queue C)
            mp.setattr(jax_attn_ops, "_FORCE_IMPL", "interpret")
        jlogits, jcache = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, max_len, q_block=BLOCK, kv_block=BLOCK))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_logits, tokens = [np.asarray(jlogits)], []
        decode = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c))
        for _ in range(DECODE_STEPS):
            tokens.append(np.asarray(jax_greedy_sample(jlogits)))
            jlogits, jcache = decode(jparams, tokens[-1], jcache)
            jax_logits.append(np.asarray(jlogits))
    params = from_jax(cfg, jparams, "cpu")
    logits, cache = T.prefill(cfg, params, batch, max_len, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    port = [logits.numpy()]
    for tok in tokens:
        logits, cache = T.decode_step(cfg, params, tok, cache, device="cpu")
        port.append(logits.numpy())
    return {"jax": jax_logits, "port": port, "tokens": tokens, "cache": cache}


@functools.cache
def placed(mesh):
    """Every case's placed run, from one spawn of 8 ranks."""
    cases = {"serve": {}, "grads": {}}
    for name, (arch, rules, changes) in SERVE.items():
        cfg = configs(arch, changes)[1]
        cases["serve"][name] = {"cfg": cfg, "params": jax_init(arch), "batch": prompt(cfg),
                                "tokens": references(name)["tokens"], "max_len": PROMPT + 8, "block": BLOCK,
                                "rules": rules, "mutant": name == "moe_mutant"}
    for name, (arch, changes) in GRADS.items():
        cfg = configs(arch, changes)[1]
        batch = prompt(cfg, seed=2)
        labels = np.roll(batch["tokens"], -1, axis=1)
        labels[0, 3] = -100  # ignored by all
        cases["grads"][name] = {"cfg": cfg, "params": jax_init(arch), "batch": {**batch, "labels": labels},
                                "block": BLOCK}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cases.pt"
        torch.save(cases, path)
        ranks = run_ranks(serving_ranks.serve_rank, int(np.prod(MESHES[mesh])), str(path), MESHES[mesh])
    for r in ranks[1:]:  # every rank gathers the same whole logits
        for name in SERVE:
            assert all(torch.equal(a, b) for a, b in zip(r["serve"][name]["logits"],
                                                         ranks[0]["serve"][name]["logits"])), name
    return ranks[0]


def max_err(got, want) -> float:
    return max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))


def held(case, mesh):
    got = placed(mesh)["serve"][case]["logits"]
    ref = references(case)
    assert len(got) == DECODE_STEPS + 1
    for which in ("port", "jax"):
        err = max_err(got, ref[which])
        assert err <= LOGITS_TOL, (case, which, err)
    return placed(mesh)["serve"][case]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_placed_prefill_and_decode_match_the_single_process_and_jax(family, mesh):
    held(family, mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_sp_kv_splits_the_cache_along_its_slots_and_merges(mesh):
    got = held("sp_kv", mesh)
    assert got["split_slots"], "kv_seq on model: the cache's k is split along its slots over model"
    assert not placed(mesh)["serve"]["dense"]["split_slots"]
    want = references("sp_kv")["cache"]["layers"][0]
    for name in ("k", "v"):  # the ranks' slices side by side are the single process's cache
        assert torch.allclose(got["whole_cache"][name], want[name], atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_a_placed_window_cache_rolls_and_wraps(mesh):
    cfg = configs("recurrentgemma-9b", {})[1]
    assert PROMPT > cfg.window  # the prefill keeps the last window positions, rolled
    got = held("hybrid", mesh)
    assert got["cache_len"] == PROMPT + DECODE_STEPS
    layers = references("hybrid")["cache"]["layers"]
    attn = next(i for i, lc in enumerate(layers) if "k" in lc)
    assert layers[attn]["k"].shape[1] == cfg.window  # circular: decode wrote slots (24 + i) % 16


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_moe_ep_matches(mesh):
    held("moe_ep", mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_placed_cache_is_placed_by_cache_axes(mesh):
    for name in SERVE:
        for pairs in placed(mesh)["serve"][name]["cache_placements"]:  # after prefill, after decode
            assert pairs and all(got == want for got, want in pairs), (name, pairs)
    first = placed(mesh)["serve"]["dense"]["cache_placements"][0]
    assert any(Shard(0) in got for got, _ in first)  # the rows split over the data axes


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_without_its_row_local_dispatch_misses_the_bound(mesh):
    """Mutation check: capacity positions counted over a rank's rows at once
    drop other assignments than the row-local dispatch does."""
    got = placed(mesh)["serve"]["moe_mutant"]["logits"]
    assert max_err(got, references("moe_mutant")["port"]) > LOGITS_TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_placing_by_views_gives_the_copies_shards_without_copying(mesh):
    """``place(..., copy=False)`` (what the serving cases run on): the same
    shapes, placements and local shards as ``place``, each shard that is
    contiguous in its whole leaf a view of it, and some leaves of each kind."""
    for name, got in placed(mesh)["views"].items():
        assert got["same"], name
        assert got["shared"] == got["contiguous"], (name, got)
    shared = sum(got["shared"] for got in placed(mesh)["views"].values())
    leaves = sum(got["leaves"] for got in placed(mesh)["views"].values())
    assert 0 < shared < leaves


@functools.cache
def grad_references(case):
    arch, changes = GRADS[case]
    cfg = configs(arch, changes)[1]
    params = from_jax(cfg, jax_init(arch), "cpu")
    batch = prompt(cfg, seed=2)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[0, 3] = -100
    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), {**batch, "labels": labels}, q_block=BLOCK, kv_block=BLOCK,
                        device="cpu")
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, wrt)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", GRADS)
def test_placed_loss_and_gradients_of_moe_encdec_and_vlm(case, mesh):
    got = placed(mesh)["grads"][case]
    loss, grads = grad_references(case)
    assert all(got["same_placements"]), "a gradient came back with other placements than its parameter's"
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (got["loss"], loss)
    for name, g, want in zip(got["names"], got["grads"], grads, strict=True):
        err = float(np.abs(g.numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)
        assert err <= GRAD_TOL, (case, name, err)
