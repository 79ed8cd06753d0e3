"""Layered configuration: ordered override stacks with per-field provenance.

The port's copy of :mod:`repro.suite.layers`.

A suite resolves every cell's configuration from a stack of *layers* —
``base`` (an ``extends``-ed spec file) ← ``suite`` (the suite file's own
``[base]`` table) ← ``cell`` (one axis-product point or explicit ``[[cells]]``
table) ← ``cli`` (``--set key=value`` overrides) — the lib_layered_config
idiom.  :func:`merge_layers` deep-merges the stack (later layers win per
leaf; tables merge, lists replace wholesale) and records, for every dotted
leaf key, *which layer set it*.  That provenance is what ``python -m repro_torch.suite run
--dry-run`` prints next to each expanded cell, so a thousand-cell sweep can
be audited field by field without simulating anything.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

__all__ = [
    "Layer",
    "Resolved",
    "merge_layers",
    "nest_dotted",
    "parse_override",
    "parse_value",
]


@dataclasses.dataclass(frozen=True)
class Layer:
    """One named override layer: a (possibly nested) mapping of fields."""

    name: str
    values: Mapping[str, Any]


@dataclasses.dataclass(frozen=True)
class Resolved:
    """A merged configuration plus per-leaf provenance.

    ``provenance`` maps dotted leaf keys (``"params.t_c"``) to the name of
    the layer that last set them; keys a merge never touched (dataclass
    defaults) simply do not appear and report as ``"default"``.
    """

    values: dict[str, Any]
    provenance: dict[str, str]

    def origin(self, dotted: str) -> str:
        return self.provenance.get(dotted, "default")


def merge_layers(layers: Sequence[Layer]) -> Resolved:
    """Deep-merge ``layers`` in order (later wins) with provenance.

    Nested mappings merge key-by-key; every other value — scalars *and*
    lists — replaces the previous one wholesale.  Replacing a table with a
    scalar (or vice versa) drops the stale subtree and its provenance.
    """
    values: dict[str, Any] = {}
    provenance: dict[str, str] = {}
    for layer in layers:
        _merge_into(values, provenance, layer.values, layer.name, prefix="")
    return Resolved(values=values, provenance=provenance)


def _drop_subtree(provenance: dict[str, str], dotted: str) -> None:
    stale = [k for k in provenance if k == dotted or k.startswith(dotted + ".")]
    for k in stale:
        del provenance[k]


def _merge_into(
    dst: dict[str, Any],
    provenance: dict[str, str],
    src: Mapping[str, Any],
    layer_name: str,
    prefix: str,
) -> None:
    for key, value in src.items():
        dotted = prefix + key
        if isinstance(value, Mapping):
            node = dst.get(key)
            if not isinstance(node, dict):
                _drop_subtree(provenance, dotted)
                node = dst[key] = {}
            _merge_into(node, provenance, value, layer_name, dotted + ".")
        else:
            _drop_subtree(provenance, dotted)
            dst[key] = list(value) if isinstance(value, (list, tuple)) else value
            provenance[dotted] = layer_name


def nest_dotted(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Lift ``{"params.t_c": 120}`` into ``{"params": {"t_c": 120}}``."""
    out: dict[str, Any] = {}
    for dotted, value in flat.items():
        node = out
        parts = dotted.split(".")
        for part in parts[:-1]:
            nxt = node.setdefault(part, {})
            if not isinstance(nxt, dict):
                raise ValueError(f"override {dotted!r} descends through non-table key {part!r}")
            node = nxt
        node[parts[-1]] = value
    return out


def parse_value(text: str) -> Any:
    """Parse one override value: JSON literal if it is one, else the raw
    string (so ``--set scheme=hour`` needs no quoting)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def parse_override(item: str) -> tuple[str, Any]:
    """Split one ``--set key.path=value`` argument."""
    key, sep, raw = item.partition("=")
    if not sep or not key:
        raise ValueError(f"override {item!r} is not of the form key=value")
    return key.strip(), parse_value(raw.strip())
