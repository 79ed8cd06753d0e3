"""The port's random init draws the JAX package's stream.

``init_params(cfg, seed)`` against the JAX package's ``init_params(cfg,
PRNGKey(seed))`` for the smoke configs of glm4-9b, recurrentgemma-9b and
falcon-mamba-7b (and every other ported architecture): in the configs'
bfloat16, every leaf within one bf16 ulp and at least 99.9 % of the elements
bit for bit; in float32, within one bf16 ulp and at least 99.5 % bit for bit
(``log`` and ``log1p`` round an ulp away from XLA's on about 0.4 % of the
draws).  The slices a weight is drawn in are the same stream, and the
int32 threefry of a draw equals the int64 one of the token pipeline.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import PORTED_ARCHS, get_smoke_config
from repro_torch.data import threefry
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax

BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


@functools.cache
def jax_init(arch, dtype, seed):
    """The JAX package's init with its default 32-bit types (another test in the
    process may have turned x64 on: the JAX engine backend does)."""
    cfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed)))


def compare(arch, dtype, seed=3) -> tuple[float, float]:
    """(share of elements bit for bit, largest difference in bf16 ulps of the JAX value)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    got = T.init_params(cfg, seed, device="cpu")
    want = from_jax(cfg, jax_init(arch, dtype, seed), "cpu")
    same = total = 0
    worst = 0.0
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        same += int((a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])).sum())
        total += a.numel()
        ulp = torch.clamp_min(b.float().abs(), 1e-30) * 2.0 ** -7
        worst = max(worst, float(((a.float() - b.float()).abs() / ulp).max()))
    return same / total, worst


@pytest.mark.parametrize("arch", ["glm4-9b", "recurrentgemma-9b", "falcon-mamba-7b"])
def test_init_equals_jax_in_the_configs_bfloat16(arch):
    share, worst = compare(arch, "bfloat16")
    assert share >= 0.999 and worst <= 1.0, (share, worst)


@pytest.mark.parametrize("arch", ["glm4-9b", "recurrentgemma-9b", "falcon-mamba-7b"])
def test_init_equals_jax_in_float32(arch):
    share, worst = compare(arch, "float32")
    assert share >= 0.995 and worst <= 1.0, (share, worst)


@pytest.mark.parametrize("arch", [a for a in PORTED_ARCHS if a not in ("glm4-9b", "recurrentgemma-9b",
                                                                         "falcon-mamba-7b")])
def test_init_equals_jax_for_the_other_architectures(arch):
    share, worst = compare(arch, "bfloat16", seed=0)
    assert share >= 0.999 and worst <= 1.0, (share, worst)


def test_slices_of_a_draw_are_the_same_stream(monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), dtype="float32")
    whole = T.init_params(cfg, 5, device="cpu")
    monkeypatch.setattr(P, "DRAW_ELEMENTS", 100)  # every weight drawn in slices of a few rows
    sliced = T.init_params(cfg, 5, device="cpu")
    for a, b in zip(tree_lib.leaves(whole), tree_lib.leaves(sliced)):
        assert torch.equal(a, b)


def test_int32_threefry_equals_the_int64_one():
    key = threefry.split(threefry.prng_key(9), 4)[3]
    for start in (0, 2**32 - 7, 10**11):
        i = torch.arange(start, start + 1000, dtype=torch.int64)
        y0, y1 = threefry.hash_words(key, i >> 32, i & 0xFFFFFFFF)
        got = threefry.random_bits(key, start, 1000).to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(got, y0 ^ y1)
