"""The port's logical-axes trees against the JAX package's, for every architecture.

``param_axes``, ``cache_axes`` and the optimizer state's ``opt_state_axes``
of ``repro_torch`` equal ``repro``'s (``==`` on the nested dicts, lists and
axis tuples) for each architecture's smoke config and its published
``CONFIG``; ``abstract_params`` (meta tensors, nothing allocated) has the JAX
package's shapes and dtypes (its ``eval_shape``) leaf for leaf.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro.optim.adamw import opt_state_axes as jax_opt_state_axes
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamBuilder
from repro_torch.optim import opt_state_axes

CONFIGS = {"smoke": (get_smoke_config, jax_get_smoke_config), "published": (get_config, jax_get_config)}


def walk(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from walk(v, (*path, i))
    else:
        yield path, tree


@pytest.mark.parametrize("which", list(CONFIGS))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_axes_trees_equal_jax(arch, which):
    port_cfg, jax_cfg = (f(arch) for f in CONFIGS[which])
    axes = T.param_axes(port_cfg)
    assert axes == JT.param_axes(jax_cfg)
    assert T.cache_axes(port_cfg) == JT.cache_axes(jax_cfg)
    assert opt_state_axes(axes) == jax_opt_state_axes(JT.param_axes(jax_cfg))


@pytest.mark.parametrize("which", list(CONFIGS))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_abstract_params_have_the_jax_shapes(arch, which):
    port_cfg, jax_cfg = (f(arch) for f in CONFIGS[which])
    got = dict(walk(T.abstract_params(port_cfg)))
    want = dict(walk(JT.abstract_params(jax_cfg)))
    assert set(got) == set(want)
    for path, spec in want.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(np.dtype(spec.dtype)), path


def test_every_parameter_has_one_axis_name_a_dimension():
    cfg = get_smoke_config("falcon-mamba-7b")
    params = dict(walk(T.init_params(cfg, 0, device="cpu")))
    axes = dict(walk(T.param_axes(cfg)))
    assert set(params) == set(axes)
    for path, a in axes.items():
        assert len(a) == params[path].dim(), path
    b = ParamBuilder(None, "meta", torch.float32)
    with pytest.raises(ValueError):
        b.dense("w", (4, 4), ("embed",))
