"""The port's logical-axis sharding against the JAX package's, on the CPU.

Every case of ``tests/parallel/test_sharding.py`` on the port (mapping,
multi-pod batch, no mesh axis used twice, the divisibility fallback and its
prefix rule, the rules context, placements on a one-rank mesh, ``shard``
off a mesh); then ``_spec_for`` of both packages on every parameter, cache
and optimizer-state leaf of all ten architectures (smoke configs and
published ones) at the production meshes (16, 16) and (2, 16, 16), with the
default rules and with ``kv_seq`` on ``model``: the JAX side on
``jax.sharding.AbstractMesh``, which needs no devices, the port's on its
:class:`AbstractMesh` and on a ``DeviceMesh`` of torch's fake process group.
The production meshes themselves are built on the fake process group.
"""

import tempfile

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.launch.mesh import fake_world, make_production_mesh, mesh_chip_count
from repro_torch.models import transformer as T
from repro_torch.optim import opt_state_axes
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AbstractMesh,
    PartitionSpec as P,
    _spec_for,
    axis_rules,
    current_rules,
    logical_sharding,
)

import torch_ranks

SP_RULES = {**DEFAULT_RULES, "kv_seq": "model"}
MESHES = {"pod": ((16, 16), ("data", "model")), "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CONFIGS = {"smoke": (get_smoke_config, jax_get_smoke_config), "published": (get_config, jax_get_config)}
#: (batch, cache length) of the caches whose specs are compared, by config
CACHE_SHAPES = {"smoke": ((8, 64), (3, 20)), "published": ((256, 32768), (4, 4096))}


@pytest.fixture
def one_rank_group():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


# ---- tests/parallel/test_sharding.py on the port ----------------------------


def test_basic_mapping():
    m = AbstractMesh((16, 16), ("data", "model"))
    spec = _spec_for(("batch", "seq", "embed"), DEFAULT_RULES, m, (256, 4096, 4096))
    assert spec == P("data", None, None)  # "pod" absent on single-pod mesh


def test_multi_pod_batch_uses_both_axes():
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = _spec_for(("batch", "seq"), DEFAULT_RULES, m, (256, 4096))
    assert spec == P(("pod", "data"), None)


def test_mesh_axis_never_used_twice():
    m = AbstractMesh((16, 16), ("data", "model"))
    # experts and mlp both map to "model": only the first keeps it
    spec = _spec_for(("experts", "fsdp", "mlp"), DEFAULT_RULES, m, (128, 7168, 4864))
    assert spec == P("model", "data", None)


def test_divisibility_fallback_drops_axis():
    m = AbstractMesh((16, 16), ("data", "model"))
    # kv_heads=2 is not divisible by 16 -> replicated
    spec = _spec_for(("fsdp", "kv_heads", "head_dim"), DEFAULT_RULES, m, (4096, 2, 128))
    assert spec == P("data", None, None)
    # but 32 heads shard fine
    spec = _spec_for(("fsdp", "heads", "head_dim"), DEFAULT_RULES, m, (4096, 32, 128))
    assert spec == P("data", "model", None)


def test_divisibility_keeps_prefix_of_tuple():
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    # batch=4: divisible by pod(2) but not pod*data(32) -> keep ("pod",)
    spec = _spec_for(("batch",), DEFAULT_RULES, m, (4,))
    assert spec == P("pod")


def test_rules_context_override():
    assert current_rules() is DEFAULT_RULES
    with axis_rules({**DEFAULT_RULES, "kv_seq": "model"}):
        assert current_rules()["kv_seq"] == "model"
    assert current_rules()["kv_seq"] is None


def test_logical_sharding_on_real_mesh(one_rank_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = S.make_compat_mesh((1,), ("data",), device_type="cpu")
    placements = logical_sharding(mesh, ("batch", None), DEFAULT_RULES, (8, 16))
    assert placements == (Shard(0),)
    x = distribute_tensor(torch.zeros((8, 16)), mesh, placements)
    assert x.placements == (Shard(0),) and tuple(x.shape) == (8, 16)
    assert logical_sharding(mesh, (None, "embed"), DEFAULT_RULES, (8, 16)) == (Replicate(),)


def test_shard_noop_outside_mesh():
    from repro_torch.parallel import shard

    x = torch.ones((4, 4))
    assert shard(x, "batch", "embed") is x


# ---- the port's mesh helpers --------------------------------------------------


def test_ambient_mesh_is_empty_outside_and_restored_after(one_rank_group):
    assert S.active_abstract_mesh().empty
    mesh = S.make_compat_mesh((1,), ("model",), device_type="cpu")
    with S.use_compat_mesh(mesh):
        inner = S.active_abstract_mesh()
        assert not inner.empty and inner.axis_names == ("model",) and inner.axis_sizes == (1,)
        assert inner.local_rank("model") == 0 and inner.group("model") is not None
    assert S.active_abstract_mesh().empty
    with pytest.raises(ValueError):
        AbstractMesh((2,), ("model",)).group("model")


def test_placements_of_a_dimension_over_two_axes():
    from torch.distributed.tensor import Replicate, Shard

    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.placements(P(("pod", "data"), "model"), m) == (Shard(0), Shard(0), Shard(1))
    assert S.placements(P(None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.placements(P(("data", "pod")), m)


def test_shard_params_maps_every_leaf():
    m = AbstractMesh((16, 16), ("data", "model"))
    cfg = get_config("glm4-9b")
    axes, abstract = T.param_axes(cfg), T.abstract_params(cfg)
    tree = S.shard_params(m, axes, DEFAULT_RULES, abstract)
    assert set(tree) == set(axes) and len(tree["layers"]) == len(axes["layers"])
    wq = tree["layers"][0]["attn.wq"]  # (4096, 32, 128): fsdp on data, heads on model
    assert wq == S.placements(P("data", "model", None), m)


@pytest.mark.parametrize("batch,want", [(8, ("pod", "data")), (4, ("pod",)), (3, ())])
def test_data_axes_keep_the_dividing_prefix(batch, want):
    m = AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert torch_ranks.data_axes(m, batch) == want
    assert torch_ranks.data_axes(m, batch) == tuple(a for a in ("pod", "data") if a in _jax_bspec(m, batch))


def _jax_bspec(mesh, b):
    """The batch axes ``repro/parallel/sp_decode.py`` keeps (its expression)."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    prod, kept = 1, []
    for a in [a for a in ("pod", "data") if a in sizes]:
        if b % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    return kept


# ---- every leaf of every architecture at the production meshes -----------------


def leaves(axes_tree, shapes_tree):
    """(logical axes, shape) of each leaf: axis tuples are leaves."""
    if isinstance(axes_tree, tuple):
        yield axes_tree, tuple(shapes_tree.shape)
    elif isinstance(axes_tree, dict):
        for k in axes_tree:
            yield from leaves(axes_tree[k], shapes_tree[k])
    else:
        for a, s in zip(axes_tree, shapes_tree, strict=True):
            yield from leaves(a, s)


def all_leaves(which, arch):
    """Every parameter, cache and optimizer-state leaf of the architecture
    (JAX's shapes, from ``eval_shape``)."""
    port_cfg, jax_cfg = (f(arch) for f in CONFIGS[which])
    params = JT.abstract_params(jax_cfg)
    out = list(leaves(T.param_axes(port_cfg), params))
    opt = {"mu": params, "nu": params, "step": jax.ShapeDtypeStruct((), "int32")}
    out += list(leaves(opt_state_axes(T.param_axes(port_cfg)), opt))
    for batch, max_len in CACHE_SHAPES[which]:
        cache = jax.eval_shape(lambda: JT.init_cache(jax_cfg, batch, max_len))  # noqa: B023
        out += list(leaves(T.cache_axes(port_cfg), cache))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("which", list(CONFIGS))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_spec_for_equals_jax_on_every_leaf(arch, which, mesh):
    shape, names = MESHES[mesh]
    jmesh, pmesh = JaxAbstractMesh(shape, names), AbstractMesh(shape, names)
    n = 0
    for axes, dims in all_leaves(which, arch):
        for rules in (DEFAULT_RULES, SP_RULES):
            jrules = {**JS.DEFAULT_RULES, "kv_seq": rules["kv_seq"]}
            for s in (dims, None):
                want = JS._spec_for(axes, jrules, jmesh, s)
                got = _spec_for(axes, rules, pmesh, s)
                assert isinstance(got, P)
                assert tuple(got) == tuple(want), (axes, s, rules["kv_seq"])
                n += 1
    assert n > 0


@pytest.mark.parametrize("multi_pod,chips", [(False, 256), (True, 512)])
def test_production_mesh_on_the_fake_process_group(multi_pod, chips):
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh_chip_count(mesh) == chips
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
        # the specs on the DeviceMesh equal those on its abstract description
        cfg = get_config("kimi-k2-1t-a32b")
        for axes, dims in leaves(T.param_axes(cfg), T.abstract_params(cfg)):
            assert _spec_for(axes, DEFAULT_RULES, mesh, dims) == _spec_for(
                axes, DEFAULT_RULES, AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names), dims)
        with S.use_compat_mesh(mesh):
            assert S.active_abstract_mesh().sizes["model"] == 16
    assert not dist.is_initialized()


def test_the_collectives_sum_and_carry_gradients_as_shard_map_does():
    # two ranks: psum passes each rank's cotangent to its own summand, pvary sums
    # the ranks' cotangents, pmean_replicas averages forward and sums backward
    for rank, out in enumerate(run_ranks(torch_ranks.collectives_rank, 2)):
        c = rank + 1.0  # each rank's cotangent
        assert out["psum"] == (3.0, c) and out["pvary"] == (c, 3.0) and out["pmean_replicas"] == (1.5, 1.5)
        assert out["psum_bf16"] == (torch.bfloat16, 3.75)
