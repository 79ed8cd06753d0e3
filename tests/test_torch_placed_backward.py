"""The placed train step's backward multiplies split weights split, as the JAX package's GSPMD program does.

JAX's ``with_sharding_constraint`` transposes to the same constraint on the
cotangent, so GSPMD reduces a partial cotangent of the residual stream where
the model annotates it, and every weight product of the backward stays split
as in the forward.  The port's ``shard`` constrains the cotangent the same way
(``parallel/sharding.py``), and Mamba's ``in_proj`` output is annotated before
it is cut in two, so that its cotangent comes back split.  Counted by the dry
run's probe (:mod:`repro_torch.launch.dryrun`, meta tensors, rank 0) on the
production 16 x 16 ``data x model`` mesh, ``train_4k`` (256 x 4096 tokens,
``remat=True``):

* glm4-9b and falcon-mamba-7b: ``flops_per_device`` equals an analytic count
  of rank 0's split products and kernels, exactly.  Each layer's products are
  counted four times (forward, the remat recompute, the two products of the
  backward), but the layer's last product (the MLP's or the mixer's output
  projection) three times: non-reentrant checkpointing stops its recompute
  once every saved tensor is back, and nothing saved needs that product.  The
  attention and SSM-scan kernels count twice forward (once recomputed) and
  ``BACKWARD_FACTOR`` times backward; the logits three times (not
  rematerialized).
* Each family's cell: the step's products count at most 4x (+1 %) the
  products of the same cell's forward alone, by the same probe (a product
  multiplied whole in the backward breaks this), and each kernel the forward
  calls at some shapes is called at those shapes twice in the step (the
  forward and the remat recompute; once for whisper's encoder, whose layers
  are not rematerialized, as in the JAX package) and its backward once, and
  no kernel at other shapes (a kernel run whole in the backward breaks this).  The
  kernels' meta operators count a backward at ``BACKWARD_FACTOR`` (3) times
  its forward, so a family whose attention FLOPs are large beside its
  products (heads that do not split over 16 run whole) counts more than 4x
  its forward in all: the 4x bound holds for the products alone.
"""

import functools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels.meta import BACKWARD_FACTOR, attention_flops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh, production_layout
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

FAMILIES = ("glm4-9b", "recurrentgemma-9b", "falcon-mamba-7b", "arctic-480b", "whisper-large-v3", "internvl2-1b")
TP, DATA = 16, 16  # the 16 x 16 mesh: model and data axes
PRODUCT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm"})  # the probe's products; its other FLOPs: the kernels


@functools.cache
def counted(arch: str) -> dict:
    """The probe's tallies of the ``train_4k`` step and of its forward alone
    (``loss_fn``, no gradient), each ``{"flops", "products", "kernels",
    "kernel_calls"}``: FLOPs, and the kernels' calls by (operator, input shapes)."""
    out = {}
    with fake_mesh(*production_layout(multi_pod=False)) as mesh:
        cell = D.build_cell(arch, "train_4k", mesh)
        qb, kb = D._BLOCKS["train_4k"]
        for which in ("step", "forward"):
            placed = D.place_meta(cell, mesh)
            probe = D.Probe()
            with S.use_compat_mesh(mesh), S.axis_rules(cell.rules), probe:
                if which == "step":
                    D.step_fn(cell)(placed)
                else:
                    with torch.no_grad():
                        T.loss_fn(cell.cfg, placed["params"], placed["batch"], q_block=qb, kv_block=kb, remat=True,
                                  device="meta")
            tally = {"flops": probe.flops, "products": 0, "kernels": 0, "kernel_calls": {}}
            for (op, shapes), (calls, flops) in probe.products.items():
                tally["products" if op in PRODUCT_OPS else "kernels"] += flops
                if op not in PRODUCT_OPS:
                    tally["kernel_calls"][op, shapes] = calls
            assert tally["products"] + tally["kernels"] == probe.flops
            out[which] = tally
    return out


def test_glm4_9b_train_flops_are_its_split_products_and_attention():
    """Rank 0 holds 16 of the 256 rows, 2 of the 32 q heads, both kv heads (2
    do not split over 16), 1/16 of the MLP and of the vocab."""
    cfg = get_config("glm4-9b")
    b, s = SHAPES["train_4k"].global_batch // DATA, SHAPES["train_4k"].seq_len
    t, d, dh = b * s, cfg.d_model, cfg.d_head
    h, kv, f, v = cfg.n_heads // TP, cfg.n_kv_heads, cfg.d_ff // TP, cfg.padded_vocab // TP
    assert cfg.n_kv_heads % TP and cfg.gated_mlp and not cfg.tie_embeddings
    attention = attention_flops((b, s, h, dh), (b, s, 1, dh), True, 0, 0, *D._BLOCKS["train_4k"])
    layer = (4 * 2 * t * d * (h + 2 * kv) * dh  # q, k, v
             + 4 * 2 * t * h * dh * d  # the output projection
             + (2 + BACKWARD_FACTOR) * attention
             + 4 * 2 * (2 * t * d * f) + 3 * 2 * t * f * d)  # gate and up; down, not recomputed
    want = cfg.n_layers * layer + 3 * 2 * t * d * v
    assert counted("glm4-9b")["step"]["flops"] == want == 346655400394752  # the parent counted 7.873e14


def test_falcon_mamba_7b_train_flops_are_its_split_products_and_scan():
    """Rank 0 holds 1/16 of the inner channels: ``in_proj``'s (4096 x 1024)
    shard of x and z, and 512 of the 8192 channels of the scan."""
    cfg = get_config("falcon-mamba-7b")
    b, s = SHAPES["train_4k"].global_batch // DATA, SHAPES["train_4k"].seq_len
    t, d, di, n, r, v = b * s, cfg.d_model, cfg.d_inner // TP, cfg.ssm_state, cfg.dt_rank, cfg.padded_vocab // TP
    layer = (4 * 2 * t * d * 2 * di  # in_proj: x and z
             + 4 * 2 * t * di * (r + 2 * n)  # x_proj
             + 4 * 2 * t * r * di  # dt_proj
             + 3 * 2 * t * di * d  # out_proj, not recomputed
             + (2 + BACKWARD_FACTOR) * 4 * b * s * di * n)  # the scan
    want = cfg.n_layers * layer + 3 * 2 * t * d * v
    assert counted("falcon-mamba-7b")["step"]["flops"] == want == 210092620251136  # the parent counted 1.020e15


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_step_counts_at_most_four_forwards(arch):
    got = counted(arch)
    step, fwd = got["step"], got["forward"]
    print(f"{arch} train_4k 16 x 16: step {step['flops']:.6g} FLOPs, forward {fwd['flops']:.6g}; products "
          f"{step['products'] / fwd['products']:.4f}x, kernels {step['kernels'] / max(fwd['kernels'], 1):.4f}x")
    assert step["products"] <= 4 * 1.01 * fwd["products"]
    assert fwd["kernel_calls"] and not any(op.endswith("_grad") for op, _ in fwd["kernel_calls"])
    cfg, want = get_config(arch), {}
    for (op, shapes), calls in fwd["kernel_calls"].items():
        encoder = cfg.family == "encdec" and shapes[0][1] == shapes[1][1] == cfg.encoder_positions
        want[op, shapes] = calls if encoder else 2 * calls  # the forward and the remat recompute
        want[op + "_grad", shapes] = calls  # keyed by the forward's inputs: the grad's last input is the cotangent
    got = {(op, shapes[:-1] if op.endswith("_grad") else shapes): calls
           for (op, shapes), calls in step["kernel_calls"].items()}
    assert got == want


def test_the_chip_smokes_placed_step_gathers_the_fsdp_leaves_alone():
    """``chip_smoke.py`` phase 17's step (glm4-9b, 4 of 40 layers, 2 x 2048,
    ``remat=False``, bf16 moments) on a 2 x 2 mesh, on meta tensors: its
    all-gathers are the FSDP gathers of the layers' leaves, one each (the
    ``model`` half of each leaf, gathered whole over ``data``), and each
    leaf's gradient is reduce-scattered once."""
    import dataclasses

    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import opt_state_axes
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=4)
    opt_cfg = AdamWConfig(lr=1e-4, moment_dtype="bfloat16")
    with fake_mesh((2, 2), ("data", "model")) as mesh, S.use_compat_mesh(mesh):
        params_abs, axes = T.abstract_params(cfg), T.param_axes(cfg)
        opt_abs = adamw_init(params_abs, opt_cfg)
        opt_sh = S.shard_params(mesh, opt_state_axes(axes), abstract_tree=opt_abs)
        opt_sh["step"] = S.logical_sharding(mesh, ())

        def one(x, pl):
            return S.zeros(x.shape, x.dtype, mesh, pl, "meta") if isinstance(x, torch.Tensor) else x

        params = S.tree_map_with(one, params_abs, S.shard_params(mesh, axes, abstract_tree=params_abs))
        opt_state = S.tree_map_with(one, opt_abs, opt_sh)
        rows = S.logical_sharding(mesh, ("batch", "seq"), shape=(2, 2048))
        batch = {k: S.zeros((2, 2048), torch.int64, mesh, rows, "meta") for k in ("tokens", "labels")}
        probe = D.Probe()
        with probe:
            make_train_step(cfg, opt_cfg, remat=False, q_block=1024, kv_block=1024)(params, opt_state, batch)
        got = probe.collectives
        print("chip_smoke phase 17's step on meta:", {k: (v["count"], v["bytes"]) for k, v in got.items()},
              "products", sum(f for (op, _), (_, f) in probe.products.items() if op in PRODUCT_OPS))
        fsdp = [w for layer in params["layers"] for w in layer.values() if w.placements[0].is_shard()]
        assert all(w.placements[1].is_shard() for w in fsdp)  # and over model: each rank gathers its half
        half = sum(w.numel() * w.element_size() // 2 for w in fsdp)
    assert got["all-gather"]["count"] == got["reduce-scatter"]["count"] == len(fsdp) == 4 * 7
    assert got["all-gather"]["bytes"] == half and got["reduce-scatter"]["bytes"] == half // 2
