"""The model assembly's table of layer kinds (``models/transformer.py::KINDS``).

Every kind that ``layer_kinds`` returns for a registered configuration has an
entry, and the cache each layer's entry makes (``init_cache``) has the tree of
logical axes the entry gives for it (``cache_axes``), leaf for leaf."""

import pytest
import torch

from repro_torch.configs import PORT_ONLY_ARCHS, PORTED_ARCHS, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def leaf_pairs(cache, axes, path="layer"):
    """``(path, leaf, its axes)`` of a cache and its axes tree, raising where
    the two trees differ in their keys."""
    if isinstance(cache, dict):
        assert isinstance(axes, dict) and set(cache) == set(axes), f"{path}: {sorted(cache)} against {axes}"
        for key in cache:
            yield from leaf_pairs(cache[key], axes[key], f"{path}.{key}")
    else:
        yield path, cache, axes


@pytest.mark.parametrize("arch", PORTED_ARCHS + PORT_ONLY_ARCHS)
def test_every_kind_has_one_entry_whose_cache_matches_its_axes(arch):
    cfg = get_smoke_config(arch)
    kinds = T.layer_kinds(cfg) + (["encoder"] if cfg.family == "encdec" else [])
    for kind in kinds:
        e = T.KINDS[kind]
        assert isinstance(e, T.Kind) and isinstance(e.mixer, L.Mixer) and e.ff in (None, "mlp", "moe"), kind
    # a window cache (max_len past the smoke window) and a whole one
    for max_len in (8, 64):
        cache, axes = T.init_cache(cfg, 2, max_len, device="cpu"), T.cache_axes(cfg)
        assert len(cache["layers"]) == len(axes["layers"]) == cfg.n_layers
        for i, (lc, la) in enumerate(zip(cache["layers"], axes["layers"])):
            for path, leaf, leaf_axes in leaf_pairs(lc, la, f"layer {i}"):
                if isinstance(leaf, torch.Tensor):
                    assert leaf.dim() == len(leaf_axes), f"{path}: {tuple(leaf.shape)} against {leaf_axes}"
                else:
                    assert leaf_axes == (), f"{path}: {leaf!r} against {leaf_axes}"
