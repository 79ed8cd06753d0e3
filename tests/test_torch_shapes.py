"""``repro_torch.configs.shapes`` against :mod:`repro.configs.shapes`: for every
(arch, shape) the same applicability and reason, and the same input names,
shapes and dtypes (the port's meta tensors against JAX's ``ShapeDtypeStruct``)."""

import dataclasses

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.configs import shapes


def test_shape_table_is_the_jax_packages():
    assert list(shapes.SHAPES) == list(jax_shapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jax_shapes.SHAPES[name])


@pytest.mark.parametrize("shape", list(jax_shapes.SHAPES))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_batch_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert shapes.applicable(cfg, shape) == jax_shapes.applicable(jcfg, shape)
    got, want = shapes.batch_specs(cfg, shape), jax_shapes.batch_specs(jcfg, shape)
    assert list(got) == list(want)
    for name, spec in want.items():
        t = got[name]
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", name
        assert tuple(t.shape) == spec.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(spec.dtype), name
