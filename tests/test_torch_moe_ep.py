"""Expert-parallel MoE in the port against the JAX package's, on the CPU.

The inputs of ``tests/parallel/test_moe_ep.py``: kimi-k2's smoke config with
8 experts, top-2 and capacity factor 8 (nothing dropped), one MoE block of
the JAX package's own init (float32) and x ``(4, 32, d)`` from a seed.  The
JAX package's ``apply_moe_ep`` runs on an 8-device fake CPU mesh (2 data x 4
model, as its own test runs it, and 2 pod x 2 data x 2 model) in a
subprocess (the device count must be set before JAX starts), with the
gradients of ``sum(y ** 2) + load_balance_loss`` with respect to the block's
weights and x; the port's runs as 8 ranks of a gloo group on the same mesh,
each on its rows and its experts, with that loss split over the data ranks
(its rows' squares, 1/n of the shared load-balance loss).

Held: y against JAX's EP and the port's dense ``apply_moe`` within atol =
rtol = 2e-5 (float32; the JAX test's tolerance: the sums over the ranks and
over each token's experts run in other orders), ``load_balance_loss`` within
rtol 1e-5, ``drop_frac`` equal (0), and the gradients within rtol 1e-4 of
their scale (float32 sums in other orders): each rank's rows of the experts'
gradients (summed over the data axes) equal JAX's rows and its other rows
are 0; the router's gradient on every rank equals JAX's whole one; each
rank's gradient of its rows of x equals JAX's rows.  Then the whole smoke
model with ``moe_impl="ep"`` (the port's init, float32) on each rank's rows:
its logits within 1e-4 (the port's float32 model tolerance) of the dense
model's forward in one process, its aux within 1e-5, and the gradients of
``loss_fn`` averaged over the data axes within rtol 1e-4 of their scale of
the dense model's ``loss_fn`` gradients on the whole batch.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import moe as JM
from repro.models.params import ParamBuilder as JaxParamBuilder
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models import moe_ep as MEP
from repro_torch.models import transformer as T
from repro_torch.parallel.ranks import run_ranks

import torch_ranks

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"data_model": ((2, 4), ("data", "model")), "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}
OVERRIDES = dict(n_experts=8, top_k=2, capacity_factor=8.0)
TOL, LB_RTOL, GRAD_RTOL, MODEL_TOL = 2e-5, 1e-5, 1e-4, 1e-4

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, warnings
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models import moe as M, moe_ep as MEP
from repro.parallel.sharding import make_compat_mesh, use_compat_mesh

inputs = np.load(sys.argv[1])
shape, axes = tuple(json.loads(sys.argv[3])), tuple(json.loads(sys.argv[4]))
cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), n_experts=8, top_k=2, capacity_factor=8.0)
p = {k[2:]: jnp.asarray(v) for k, v in inputs.items() if k.startswith("p:")}
x = jnp.asarray(inputs["x"])

def loss(moe):
    def f(p, x):
        y, aux = moe(cfg, p, "moe", x)
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux["load_balance_loss"]
    return f

mesh = make_compat_mesh(shape, axes)
with use_compat_mesh(mesh):
    y, aux = jax.jit(lambda p, x: MEP.apply_moe_ep(cfg, p, "moe", x))(p, x)
    g = jax.jit(jax.grad(loss(MEP.apply_moe_ep)))(p, x)
gd, dxd = jax.jit(jax.grad(loss(M.apply_moe), argnums=(0, 1)))(p, x)
np.savez(sys.argv[2], y=np.asarray(y), lb=np.asarray(aux["load_balance_loss"]), drop=np.asarray(aux["drop_frac"]),
         dx_dense=np.asarray(dxd), **{"g:" + k: np.asarray(v) for k, v in g.items()},
         **{"gd:" + k: np.asarray(v) for k, v in gd.items()})
print("EP_MOE_JAX_OK")
"""


def f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    """The block's parameters (JAX's init) and x, also as the JAX script's npz."""
    jcfg = dataclasses.replace(jax_get_smoke_config("kimi-k2-1t-a32b"), **OVERRIDES)
    b = JaxParamBuilder(jax.random.PRNGKey(0), dtype=jnp.float32)
    JM.init_moe(b, "moe", jcfg)
    params = {k: np.array(v) for k, v in b.params.items()}
    x = np.random.default_rng(1).standard_normal((4, 32, jcfg.d_model)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("moe_ep")
    np.savez(tmp / "inputs.npz", x=x, **{"p:" + k: v for k, v in params.items()})
    return params, x, tmp


def jax_ep(tmp, shape, axes) -> dict:
    """The JAX package's ``apply_moe_ep`` and its weights' gradients on a fake
    CPU mesh, and the gradients of the same loss through its ``apply_moe``."""
    out = tmp / f"jax_{'_'.join(axes)}.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), str(out), json.dumps(shape),
                        json.dumps(axes)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert "EP_MOE_JAX_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    got = np.load(out)
    return {"y": got["y"], "lb": float(got["lb"]), "drop": float(got["drop"]), "dx_dense": got["dx_dense"],
            "grads": {k[2:]: got[k] for k in got.files if k.startswith("g:")},
            "grads_dense": {k[3:]: got[k] for k in got.files if k.startswith("gd:")}}


def assert_grad_close(got, want, what):
    got = f32(got)
    assert np.isfinite(got).all() and np.abs(got).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want).max(), err_msg=what)


def is_expert_weight(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in {f"moe.{w}" for w in MEP.EXPERT_WEIGHTS}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_ep_matches_jax_and_the_dense_dispatch(block, mesh):
    params, x, tmp = block
    shape, axes = MESHES[mesh]
    want = jax_ep(tmp, shape, axes)
    tp, n = shape[-1], int(np.prod(shape))
    rows, e_loc = x.shape[0] // (n // tp), 8 // tp
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), **OVERRIDES)
    model_cfg = dataclasses.replace(cfg, dtype="float32", moe_impl="ep")
    model_params = T.init_params(model_cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    torch.save({"cfg": cfg, "params": params, "x": x, "model_cfg": model_cfg, "model_params": model_params,
                "tokens": tokens, "labels": labels}, tmp / "port_inputs.pt")
    ranks = run_ranks(torch_ranks.moe_ep_rank, n, tmp / "port_inputs.pt", shape, axes)
    dense_cfg = dataclasses.replace(model_cfg, moe_impl="dense")
    logits_dense, aux_model = T._forward(dense_cfg, model_params, {"tokens": tokens}, device="cpu")
    dense_leaves = torch_ranks.flat(model_params)
    for v in dense_leaves.values():
        v.requires_grad_(True)
    loss_dense, _ = T.loss_fn(dense_cfg, model_params, {"tokens": tokens, "labels": labels}, device="cpu")
    loss_dense.backward()
    y_dense, aux_dense = M.apply_moe(cfg, {k: torch.from_numpy(v) for k, v in params.items()}, "moe",
                                     torch.from_numpy(x))
    assert float(aux_dense["drop_frac"]) == 0.0
    for r, out in enumerate(ranks):
        lo, hi = out["rows"]
        e0, e1 = out["experts"]
        assert (lo, hi) == (rows * (r // tp), rows * (r // tp + 1))  # the data axes split the batch, pod first
        assert (e0, e1) == (e_loc * (r % tp), e_loc * (r % tp + 1))
        np.testing.assert_allclose(f32(out["y"]), want["y"][lo:hi], atol=TOL, rtol=TOL, err_msg=f"rank {r} y")
        np.testing.assert_allclose(f32(out["y"]), f32(y_dense[lo:hi]), atol=TOL, rtol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(out["load_balance_loss"]), want["lb"], rtol=LB_RTOL)
        np.testing.assert_allclose(float(out["load_balance_loss"]), float(aux_dense["load_balance_loss"]),
                                   rtol=LB_RTOL)
        assert float(out["drop_frac"]) == want["drop"] == 0.0
        for key, g in out["grads"].items():
            if key.split(".", 1)[1] in MEP.EXPERT_WEIGHTS:  # this rank's rows; the others are other ranks'
                assert_grad_close(g[e0:e1], want["grads"][key][e0:e1], f"rank {r} {key}")
                assert_grad_close(g[e0:e1], want["grads_dense"][key][e0:e1], f"rank {r} {key} (dense)")
                assert not torch.cat([g[:e0], g[e1:]]).any(), (r, key)
            else:  # the router: the whole gradient on every rank
                assert_grad_close(g, want["grads_dense"][key], f"rank {r} {key}")
        assert_grad_close(out["dx"], want["dx_dense"][lo:hi], f"rank {r} dx")
        # the whole model: every MoE layer through apply_moe_ep, against the dense model
        np.testing.assert_allclose(f32(out["model_logits"]), f32(logits_dense[lo:hi]), atol=MODEL_TOL, rtol=MODEL_TOL)
        for name in ("load_balance_loss", "drop_frac"):
            np.testing.assert_allclose(float(out["model_aux"][name]), float(aux_model[name]), rtol=LB_RTOL)
        assert set(out["model_grads"]) == set(dense_leaves)
        for key, g in out["model_grads"].items():
            whole = f32(dense_leaves[key].grad)
            if is_expert_weight(key):
                assert_grad_close(g[e0:e1], whole[e0:e1], f"rank {r} model {key}")
                assert not torch.cat([g[:e0], g[e1:]]).any(), (r, key)
            else:
                assert_grad_close(g, whole, f"rank {r} model {key}")
    mean_loss = np.mean([float(out["model_loss"]) for out in ranks])
    np.testing.assert_allclose(mean_loss, float(loss_dense.detach()), rtol=MODEL_TOL)


def test_off_a_mesh_and_with_an_undivided_axis_it_is_the_dense_moe():
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), **OVERRIDES)
    from repro_torch.parallel.sharding import AbstractMesh, use_compat_mesh

    p = T.init_params(dataclasses.replace(cfg, dtype="float32"), 0, device="cpu")["layers"][0]
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(3))
    y, aux = MEP.apply_moe_ep(cfg, p, "moe", x)
    y_dense, aux_dense = M.apply_moe(cfg, p, "moe", x)
    assert torch.equal(y, y_dense) and torch.equal(aux["drop_frac"], aux_dense["drop_frac"])
    with use_compat_mesh(AbstractMesh((3,), ("model",))):  # 8 experts over 3 ranks: the dense MoE
        y3, _ = MEP.apply_moe_ep(cfg, p, "moe", x)
    assert torch.equal(y3, y_dense)


def test_local_experts_are_the_ranks_rows():
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"), dtype="float32")
    p = T.init_params(cfg, 0, device="cpu")["layers"][0]
    parts = [MEP.local_experts(p, "moe", r, 4) for r in range(4)]
    for name in MEP.EXPERT_WEIGHTS:
        whole = p[f"moe.{name}"]
        assert torch.equal(torch.cat([q[f"moe.{name}"] for q in parts]), whole)
        assert parts[1][f"moe.{name}"].data_ptr() == whole[2].data_ptr()  # a view: rows 2..3
    assert parts[3]["moe.router"] is p["moe.router"] and parts[0]["attn.wq"] is p["attn.wq"]
    with pytest.raises(ValueError):
        MEP.local_experts(p, "moe", 0, 3)
