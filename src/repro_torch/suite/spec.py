"""Declarative scenario suites: TOML/JSON specs expanded to frozen scenarios.

The port's copy of :mod:`repro.suite.spec`: the same files load unchanged
and expand to the port's :class:`~repro_torch.engine.Scenario`,
:class:`~repro_torch.engine.FleetScenario` and
:class:`~repro_torch.serving.ServingScenario`, whose canonical forms (and so
hashes) equal the JAX package's for the same cell.

A *suite file* describes a whole study — the armi ``cases/`` idiom — as
data::

    [suite]
    name = "paper_fig7"
    kind = "scenario"          # or "fleet" / "serving"
    engine = "auto"            # any repro_torch.engine backend id
    # extends = "common.toml"  # optional deeper base layer(s)

    [base]                     # shared scenario fields (the "suite" layer)
    work_s = 30000.0
    instances = ["m1.xlarge/eu-west-1"]
    bids = [0.401, 0.404, 0.407]

    [axes]                     # cross-product axes -> one cell per point
    schemes = ["opt", "hour", "edge"]
    seeds = [0, 1]

    [[cells]]                  # optional explicit extra cells
    label = "contended"
    capacity = 8
    demand = 2

:func:`load_suite` parses the file; :meth:`Suite.expand` resolves every cell
through the layer stack (``base`` ← ``suite`` ← ``cell`` ← ``cli``, see
:mod:`repro_torch.suite.layers`), materializes a frozen
:class:`~repro_torch.engine.scenario.Scenario` / ``FleetScenario`` per cell, and
keeps the per-field provenance for ``--dry-run`` auditing.  Axis values that
land on grid-typed scenario fields (``bids`` / ``seeds`` / ``schemes`` /
``instances`` / ``policies`` / ``bid_margins``) may be scalars — they are
wrapped to one-element grids, so ``axes.seeds = [0, 1, 2]`` means three
cells of one seed each.

TOML cannot write ``null``: optional fields accept the string ``"none"``
(so ``axes.capacity = ["none", 8, 4]`` sweeps an uncontended cell against
two pool depths).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
from typing import Any, Mapping, Sequence

from repro_torch.core.market import InstanceType, catalog, get_instance
from repro_torch.core.provision import SLA
from repro_torch.core.schemes import Scheme, SimParams
from repro_torch.engine.scenario import FleetScenario, Scenario
from repro_torch.market import MarketParams
from repro_torch.serving import ServingScenario
from repro_torch.suite.layers import Layer, Resolved, merge_layers, nest_dotted

__all__ = ["Suite", "SuiteCell", "load_suite", "build_scenario"]

_TOP_LEVEL_KEYS = {"suite", "base", "axes", "cells"}
_KINDS = ("scenario", "fleet", "serving")

#: Spec keys accepted for kind="scenario" (besides the layered "engine").
SCENARIO_KEYS = {
    "work_s",
    "bids",
    "schemes",
    "params",
    "instances",
    "horizon_days",
    "seeds",
    "initial_saved_work",
    "sla",
    "bid_fractions",
    "capacity",
    "demand",
    "market",
}

#: Spec keys accepted for kind="fleet".
FLEET_KEYS = {
    "n_jobs",
    "mean_interarrival_s",
    "mean_work_h",
    "horizon_days",
    "n_types",
    "seeds",
    "bid_margins",
    "scheme",
    "sla",
    "n_replicas",
    "deadline_slack",
    "policies",
    "capacity",
    "market",
    "bid_policy",
    "rebid_markup",
}

#: Spec keys accepted for kind="serving" (see repro_torch.serving.ServingScenario).
SERVING_KEYS = {
    "base_rps",
    "diurnal_amplitude",
    "diurnal_period_s",
    "diurnal_phase_s",
    "flash_crowds",
    "flash_magnitude",
    "flash_duration_s",
    "jitter",
    "horizon_days",
    "control_period_s",
    "seeds",
    "on_demand_replicas",
    "on_demand_type",
    "spot_types",
    "rps_capacity_ref",
    "boot_delay_s",
    "drain_delay_s",
    "max_spot",
    "policies",
    "target_utilization",
    "threshold_hi",
    "threshold_lo",
    "threshold_step",
    "hazard_window_s",
    "bid_margins",
    "capacity",
    "market",
    "slo_p99_s",
}


# ---------------------------------------------------------------------------
# Value coercion: spec literals -> scenario field types
# ---------------------------------------------------------------------------


def _is_none(v: Any) -> bool:
    return v is None or (isinstance(v, str) and v.lower() in ("none", "null"))


def _wrap(v: Any) -> list:
    """Grid fields accept a scalar axis value as a one-element grid."""
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _scheme(v: Any) -> Scheme:
    if isinstance(v, Scheme):
        return v
    try:
        return Scheme(str(v).lower())
    except ValueError:
        raise ValueError(
            f"unknown scheme {v!r}; expected one of {[s.value for s in Scheme]}"
        ) from None


def _sub_table(name: str, v: Any, cls, float_fields: set[str], optional: set[str] = frozenset()):
    """Build a frozen params dataclass from a spec sub-table, coercing
    numerics to float so int-vs-float spellings hash identically."""
    if not isinstance(v, Mapping):
        raise ValueError(f"{name} must be a table, got {v!r}")
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = set(v) - allowed
    if unknown:
        raise ValueError(f"unknown {name} keys {sorted(unknown)}; allowed: {sorted(allowed)}")
    kwargs = {}
    for k, x in v.items():
        if k in optional and _is_none(x):
            kwargs[k] = None
        elif k in float_fields:
            kwargs[k] = float(x)
        else:
            kwargs[k] = x
    return cls(**kwargs)


def _sim_params(v: Any) -> SimParams:
    names = {f.name for f in dataclasses.fields(SimParams)}
    return _sub_table("params", v, SimParams, float_fields=names)


def _market_params(v: Any) -> MarketParams:
    names = {f.name for f in dataclasses.fields(MarketParams)}
    return _sub_table("market", v, MarketParams, float_fields=names, optional={"ref_price"})


def _sla(v: Any) -> SLA:
    if not isinstance(v, Mapping):
        raise ValueError(f"sla must be a table, got {v!r}")
    unknown = set(v) - {"min_compute_units", "regions", "os"}
    if unknown:
        raise ValueError(f"unknown sla keys {sorted(unknown)}")
    return SLA(
        min_compute_units=float(v.get("min_compute_units", 0.0)),
        regions=tuple(str(r) for r in _wrap(v.get("regions", []))),
        os=None if _is_none(v.get("os")) else str(v["os"]),
    )


def _instance(spec: Any) -> InstanceType:
    """Resolve ``"hardware"`` / ``"hardware/region"`` / ``"hardware/region/os"``."""
    if isinstance(spec, InstanceType):
        return spec
    parts = str(spec).split("/")
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"instance spec {spec!r} is not hardware[/region[/os]]")
    return get_instance(*parts)


def build_scenario(kind: str, values: Mapping[str, Any]) -> Scenario | FleetScenario | ServingScenario:
    """Materialize one cell's merged spec values into a frozen scenario.

    Only keys present in ``values`` are passed through — everything else
    keeps the dataclass default, so hashing a spec that omits a field equals
    hashing one that spells out the default (numeric coercion guarantees the
    int/float spelling does too).
    """
    if kind == "fleet":
        return _build_fleet(values)
    if kind == "serving":
        return _build_serving(values)
    if kind == "scenario":
        return _build_single(values)
    raise ValueError(f"unknown suite kind {kind!r}; expected one of {_KINDS}")


def _build_single(values: Mapping[str, Any]) -> Scenario:
    v = dict(values)
    unknown = set(v) - SCENARIO_KEYS
    if unknown:
        raise ValueError(f"unknown scenario keys {sorted(unknown)}; allowed: {sorted(SCENARIO_KEYS)}")
    for required in ("work_s", "bids"):
        if required not in v:
            raise ValueError(f"scenario spec needs {required!r}")

    sla = _sla(v["sla"]) if "sla" in v else None
    inst_spec = v.get("instances", "catalog")
    if isinstance(inst_spec, str) and inst_spec == "catalog":
        instances = list(catalog())
    else:
        instances = [_instance(s) for s in _wrap(inst_spec)]
    if sla is not None:
        instances = [it for it in instances if sla.admits(it)]
    if not instances:
        raise ValueError("no instances left after SLA filter")

    kwargs: dict[str, Any] = {
        "work_s": float(v["work_s"]),
        "bids": tuple(float(b) for b in _wrap(v["bids"])),
        "instances": tuple(instances),
        "sla": sla,
    }
    if "schemes" in v:
        kwargs["schemes"] = tuple(_scheme(s) for s in _wrap(v["schemes"]))
    if "params" in v:
        kwargs["params"] = _sim_params(v["params"])
    if "market" in v:
        kwargs["market"] = _market_params(v["market"])
    if "horizon_days" in v:
        kwargs["horizon_days"] = float(v["horizon_days"])
    if "seeds" in v:
        kwargs["seeds"] = tuple(int(s) for s in _wrap(v["seeds"]))
    if "initial_saved_work" in v:
        kwargs["initial_saved_work"] = float(v["initial_saved_work"])
    if "bid_fractions" in v:
        kwargs["bid_fractions"] = bool(v["bid_fractions"])
    if "capacity" in v and not _is_none(v["capacity"]):
        kwargs["capacity"] = int(v["capacity"])
    if "demand" in v:
        kwargs["demand"] = int(v["demand"])
    return Scenario(**kwargs)


def _build_fleet(values: Mapping[str, Any]) -> FleetScenario:
    v = dict(values)
    unknown = set(v) - FLEET_KEYS
    if unknown:
        raise ValueError(f"unknown fleet keys {sorted(unknown)}; allowed: {sorted(FLEET_KEYS)}")
    kwargs: dict[str, Any] = {}
    for key, conv in (
        ("n_jobs", int),
        ("mean_interarrival_s", float),
        ("mean_work_h", float),
        ("horizon_days", float),
        ("n_types", int),
        ("n_replicas", int),
        ("rebid_markup", float),
        ("bid_policy", str),
    ):
        if key in v:
            kwargs[key] = conv(v[key])
    if "seeds" in v:
        kwargs["seeds"] = tuple(int(s) for s in _wrap(v["seeds"]))
    if "bid_margins" in v:
        kwargs["bid_margins"] = tuple(float(m) for m in _wrap(v["bid_margins"]))
    if "policies" in v:
        kwargs["policies"] = tuple(str(p) for p in _wrap(v["policies"]))
    if "scheme" in v:
        kwargs["scheme"] = _scheme(v["scheme"])
    if "sla" in v:
        kwargs["sla"] = _sla(v["sla"])
    if "market" in v:
        kwargs["market"] = _market_params(v["market"])
    if "deadline_slack" in v:
        kwargs["deadline_slack"] = None if _is_none(v["deadline_slack"]) else float(v["deadline_slack"])
    if "capacity" in v and not _is_none(v["capacity"]):
        kwargs["capacity"] = int(v["capacity"])
    return FleetScenario(**kwargs)


def _build_serving(values: Mapping[str, Any]) -> ServingScenario:
    v = dict(values)
    unknown = set(v) - SERVING_KEYS
    if unknown:
        raise ValueError(f"unknown serving keys {sorted(unknown)}; allowed: {sorted(SERVING_KEYS)}")
    kwargs: dict[str, Any] = {}
    for key, conv in (
        ("base_rps", float),
        ("diurnal_amplitude", float),
        ("diurnal_period_s", float),
        ("diurnal_phase_s", float),
        ("flash_crowds", int),
        ("flash_magnitude", float),
        ("flash_duration_s", float),
        ("jitter", float),
        ("horizon_days", float),
        ("control_period_s", float),
        ("on_demand_replicas", int),
        ("rps_capacity_ref", float),
        ("boot_delay_s", float),
        ("drain_delay_s", float),
        ("max_spot", int),
        ("target_utilization", float),
        ("threshold_hi", float),
        ("threshold_lo", float),
        ("threshold_step", int),
        ("hazard_window_s", float),
        ("slo_p99_s", float),
    ):
        if key in v:
            kwargs[key] = conv(v[key])
    if "seeds" in v:
        kwargs["seeds"] = tuple(int(s) for s in _wrap(v["seeds"]))
    if "bid_margins" in v:
        kwargs["bid_margins"] = tuple(float(m) for m in _wrap(v["bid_margins"]))
    if "policies" in v:
        kwargs["policies"] = tuple(str(p) for p in _wrap(v["policies"]))
    if "on_demand_type" in v:
        kwargs["on_demand_type"] = _instance(v["on_demand_type"])
    if "spot_types" in v:
        kwargs["spot_types"] = tuple(_instance(s) for s in _wrap(v["spot_types"]))
    if "market" in v:
        kwargs["market"] = _market_params(v["market"])
    if "capacity" in v and not _is_none(v["capacity"]):
        kwargs["capacity"] = int(v["capacity"])
    return ServingScenario(**kwargs)


# ---------------------------------------------------------------------------
# Suite: the parsed file and its expansion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuiteCell:
    """One expanded cell: a frozen scenario plus how it was resolved."""

    index: int
    label: str
    kind: str
    engine: str
    scenario: Scenario | FleetScenario | ServingScenario
    resolved: Resolved

    def describe(self) -> str:
        """Human-readable resolution: every set field with its layer."""
        lines = [f"[{self.index}] {self.label}  (kind={self.kind}, engine={self.engine})"]
        for dotted, value in sorted(_leaves(self.resolved.values)):
            lines.append(f"    {dotted} = {json.dumps(value)}  <- {self.resolved.origin(dotted)}")
        return "\n".join(lines)


def _leaves(values: Mapping[str, Any], prefix: str = "") -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    for k, v in values.items():
        dotted = prefix + k
        if isinstance(v, Mapping):
            out.extend(_leaves(v, dotted + "."))
        else:
            out.append((dotted, v))
    return out


def _fmt(v: Any) -> str:
    return v if isinstance(v, str) else json.dumps(v)


@dataclasses.dataclass(frozen=True)
class Suite:
    """A parsed suite file: layer stack + axes, expandable to cells."""

    name: str
    kind: str
    engine: str
    description: str
    layers: tuple[Layer, ...]
    axes: tuple[tuple[str, tuple[Any, ...]], ...]
    cells: tuple[Mapping[str, Any], ...]
    path: str | None = None

    @property
    def n_cells(self) -> int:
        n = 1
        for _, vals in self.axes:
            n *= len(vals)
        if not self.axes and self.cells:
            n = 0
        return n + len(self.cells)

    def _cell_layers(self) -> list[tuple[str, Layer]]:
        out: list[tuple[str, Layer]] = []
        if self.axes:
            names = [a for a, _ in self.axes]
            for combo in itertools.product(*[vals for _, vals in self.axes]):
                overrides = dict(zip(names, combo))
                label = ",".join(f"{k}={_fmt(x)}" for k, x in overrides.items())
                out.append((label, Layer("cell", overrides)))
        elif not self.cells:
            out.append(("base", Layer("cell", {})))
        for i, table in enumerate(self.cells):
            t = dict(table)
            label = str(t.pop("label", f"cells[{i}]"))
            out.append((label, Layer("cell", t)))
        return out

    def expand(self, cli: Mapping[str, Any] | None = None) -> list[SuiteCell]:
        """Resolve every cell through the full layer stack and materialize
        its frozen scenario.  ``cli`` holds dotted-key overrides (the
        outermost layer, e.g. from ``--set``)."""
        stack_tail = [Layer("cli", nest_dotted(cli))] if cli else []
        cells: list[SuiteCell] = []
        for index, (label, cell_layer) in enumerate(self._cell_layers()):
            resolved = merge_layers([*self.layers, cell_layer, *stack_tail])
            values = dict(resolved.values)
            engine = str(values.pop("engine", self.engine))
            cells.append(
                SuiteCell(
                    index=index,
                    label=label,
                    kind=self.kind,
                    engine=engine,
                    scenario=build_scenario(self.kind, values),
                    resolved=resolved,
                )
            )
        return cells


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _load_doc(path: pathlib.Path) -> dict:
    if path.suffix.lower() == ".json":
        return json.loads(path.read_text())
    try:
        import tomllib  # py311+
    except ModuleNotFoundError:
        try:
            import tomli as tomllib
        except ModuleNotFoundError:
            raise ModuleNotFoundError(
                f"reading {path.name} needs a TOML parser: python >= 3.11 (tomllib) "
                "or `pip install tomli`; JSON suite files need neither"
            ) from None
    with path.open("rb") as f:
        return tomllib.load(f)


def _base_layers(path: pathlib.Path, doc: dict, seen: tuple[pathlib.Path, ...]) -> list[Layer]:
    """The inherited layer stack of one file: its own bases first."""
    if path in seen:
        chain = " -> ".join(p.name for p in (*seen, path))
        raise ValueError(f"extends cycle: {chain}")
    layers: list[Layer] = []
    extends = (doc.get("suite") or {}).get("extends")
    if extends:
        base_path = (path.parent / extends).resolve()
        layers.extend(_base_layers(base_path, _load_doc(base_path), (*seen, path)))
    name = "suite" if not seen else f"base:{path.name}"
    layers.append(Layer(name, doc.get("base") or {}))
    return layers


def load_suite(path: str | pathlib.Path) -> Suite:
    """Parse a TOML (or ``.json``) suite file into a :class:`Suite`."""
    path = pathlib.Path(path).resolve()
    doc = _load_doc(path)
    unknown = set(doc) - _TOP_LEVEL_KEYS
    if unknown:
        raise ValueError(f"unknown top-level keys {sorted(unknown)} in {path.name}; "
                         f"allowed: {sorted(_TOP_LEVEL_KEYS)}")
    meta = doc.get("suite") or {}
    kind = str(meta.get("kind", "scenario"))
    if kind not in _KINDS:
        raise ValueError(f"suite kind {kind!r} must be one of {_KINDS}")
    axes_table = doc.get("axes") or {}
    axes = []
    for field, vals in axes_table.items():
        if not isinstance(vals, (list, tuple)) or not vals:
            raise ValueError(f"axis {field!r} must be a non-empty list, got {vals!r}")
        axes.append((str(field), tuple(vals)))
    cells = doc.get("cells") or []
    if not isinstance(cells, list):
        raise ValueError("cells must be an array of tables ([[cells]])")
    return Suite(
        name=str(meta.get("name", path.stem)),
        kind=kind,
        engine=str(meta.get("engine", "auto")),
        description=str(meta.get("description", "")),
        layers=tuple(_base_layers(path, doc, ())),
        axes=tuple(axes),
        cells=tuple(dict(c) for c in cells),
        path=str(path),
    )
