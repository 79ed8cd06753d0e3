"""Deterministic fault-injection plane: seeded plans fired at named sites.

A copy of :mod:`repro.faults.plan` (the port imports nothing of the JAX
package).  A :class:`FaultPlan` perturbs what the stack does -- failing or
tearing checkpoint writes, failing restores -- so the recovery paths (the
trainer's checkpoint fallback) can be exercised end to end.  Instrumented
code never takes a plan as an argument: it calls :func:`current`, which
returns the innermost LIFO-activated plan or the no-op :data:`NULL`::

    from repro_torch import faults

    plan = faults.FaultPlan([faults.FaultRule("ckpt.restore", key="77")], seed=0)
    with plan:
        trainer.run()                    # the restore of step 77 fails
    print(plan.log)                      # every injected action, replayable

**Determinism.**  Whether a site fires is a pure function of
``(plan.seed, site, key)`` -- never of wall clock, thread interleaving, or
call order -- and the same as the JAX package's decision for the same
triple (the same sha256 deviate).  ``key`` is the site's stable context (a
checkpoint step): each key draws one uniform deviate and, when selected,
fires on its first ``max_fires`` hits.

**Sites** are registered in :data:`SITES` (name -> behavior summary)::

    ckpt.save           one hit per checkpoint write        (raise | torn)
    ckpt.restore        one hit per checkpoint restore      (raise)

and other code may add its own with :func:`register_site`.
:func:`load_plan` warns about rules naming sites nobody registered.  Every
fired action counts ``faults.injected`` (and ``faults.injected.<site>``) on
the current telemetry collector.

``REPRO_FAULTS=<schedule.json|.toml>`` names a committed fault schedule
(:func:`plan_from_env`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pathlib
import threading
from typing import Any, Iterable, Mapping

from repro_torch.obs import telemetry as obs

__all__ = [
    "NULL",
    "SITES",
    "FaultAction",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "activate",
    "current",
    "load_plan",
    "plan_from_env",
    "register_site",
]

log = logging.getLogger("repro_torch.faults")

#: Environment variable naming a fault-schedule file to activate ambiently.
ENV_VAR = "REPRO_FAULTS"

_KINDS = ("raise", "torn", "hang")

#: Every known injection site: name -> one-line behavior summary.  Other code
#: registers its own (:func:`register_site`), and :func:`load_plan` warns
#: about schedule rules naming sites nobody registered.
SITES: dict[str, str] = {
    "ckpt.save": "one hit per checkpoint write (raise | torn)",
    "ckpt.restore": "one hit per checkpoint restore (raise)",
}


def register_site(site: str, description: str) -> None:
    """Declare an injection site (idempotent; re-registration must agree).

    Registration is documentation plus the :func:`load_plan` typo guard —
    firing an unregistered site still works, so ad-hoc experiments need no
    ceremony, but committed schedules get validated against this dict.
    """
    existing = SITES.get(site)
    if existing is not None and existing != description:
        raise ValueError(
            f"fault site {site!r} already registered with a different description"
        )
    SITES[site] = description


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule: *where*, *how*, and *how often*.

    ``p`` is the per-**key** selection probability: each distinct ``key``
    seen at ``site`` is selected (or not) once, deterministically, and a
    selected key fires on its first ``max_fires`` hits.  ``key`` pins the
    rule to one exact key instead (``p`` still applies).  ``after`` skips a
    key's first hits (e.g. ``after=1`` lets the first attempt succeed and
    fails the retry).  ``delay_s`` is the stall length for ``kind="hang"``.
    """

    site: str
    kind: str = "raise"  # raise | torn | hang
    p: float = 1.0
    key: str | None = None  # None = any key at the site
    max_fires: int = 1
    after: int = 0
    delay_s: float = 0.25
    message: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {_KINDS}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} outside [0, 1]")
        if self.max_fires < 1:
            raise ValueError("max_fires must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One injected failure, as handed to (and logged for) the site."""

    site: str
    kind: str
    key: str  # the site's stable context (run key, step, ...)
    hit: int  # 0-based hit index at (site, key) when this fired
    delay_s: float
    message: str

    def describe(self) -> str:
        return f"{self.site}[{self.key}] hit={self.hit} kind={self.kind}"


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-kind action (and by :meth:`FaultPlan.check`)."""

    def __init__(self, action: FaultAction):
        self.action = action
        msg = action.message or f"injected fault: {action.describe()}"
        super().__init__(msg)


def _deviate(seed: int, site: str, key: str) -> float:
    """Uniform [0, 1) deviate, a pure function of (seed, site, key)."""
    digest = hashlib.sha256(f"{seed}|{site}|{key}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


class FaultPlan:
    """A seeded, replayable set of :class:`FaultRule`\\ s.

    Entering the plan activates it (sites then consult it via
    :func:`current`); exiting deactivates it.  The same plan object may be
    re-entered — per-key hit counters persist across activations, so a plan
    spanning "faulted pass, then clean pass" keeps its budgets spent.
    """

    enabled = True

    def __init__(self, rules: Iterable[FaultRule] = (), seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self.log: list[FaultAction] = []  # every fired action, in firing order
        self._hits: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()

    # -- the injection decision ---------------------------------------------

    def fire(self, site: str, key: Any = "") -> FaultAction | None:
        """One site hit: the action to inject, or ``None`` (the common case).

        Thread-safe; the decision depends only on ``(seed, site, key)`` and
        the number of previous hits at that pair, so concurrent cells cannot
        perturb each other's failures.
        """
        key = str(key)
        with self._lock:
            hit = self._hits.get((site, key), 0)
            self._hits[(site, key)] = hit + 1
            for rule in self.rules:
                if rule.site != site:
                    continue
                if rule.key is not None and rule.key != key:
                    continue
                if not rule.after <= hit < rule.after + rule.max_fires:
                    continue
                if _deviate(self.seed, site, key) >= rule.p:
                    continue
                action = FaultAction(
                    site=site, kind=rule.kind, key=key, hit=hit,
                    delay_s=rule.delay_s, message=rule.message,
                )
                self.log.append(action)
                tel = obs.current()
                tel.count("faults.injected")
                tel.count(f"faults.injected.{site}")
                return action
        return None

    def check(self, site: str, key: Any = "") -> None:
        """Fire ``site`` and raise :class:`InjectedFault` on a ``raise``
        action (sites with no kind-specific behavior use this form)."""
        action = self.fire(site, key)
        if action is not None and action.kind == "raise":
            raise InjectedFault(action)

    def injected(self, site: str | None = None) -> list[FaultAction]:
        """The fired actions so far, optionally filtered by site."""
        return [a for a in self.log if site is None or a.site == site]

    def describe(self) -> str:
        rules = "; ".join(
            f"{r.site}:{r.kind} p={r.p} x{r.max_fires}"
            + (f" key={r.key}" if r.key is not None else "")
            + (f" after={r.after}" if r.after else "")
            for r in self.rules
        )
        return f"FaultPlan(seed={self.seed}, {len(self.rules)} rules: {rules})"

    # -- activation (LIFO, mirroring obs.telemetry) --------------------------

    def __enter__(self) -> "FaultPlan":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


class _NullFaultPlan(FaultPlan):
    """The disabled plan: never fires, cannot be activated."""

    enabled = False

    def fire(self, site: str, key: Any = "") -> None:
        return None

    def check(self, site: str, key: Any = "") -> None:
        return None

    def __enter__(self):
        raise RuntimeError("the NULL fault plan cannot be activated")


#: The module-wide disabled plan; :func:`current` returns it when nothing is
#: activated, so injection sites can call unconditionally.
NULL = _NullFaultPlan()

_ACTIVE: list[FaultPlan] = []


def current() -> FaultPlan:
    """The innermost activated plan, or :data:`NULL` when none is."""
    return _ACTIVE[-1] if _ACTIVE else NULL


class _Activation:
    __slots__ = ("_plan",)

    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def __enter__(self) -> FaultPlan:
        _ACTIVE.append(self._plan)
        return self._plan

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def activate(plan: FaultPlan) -> _Activation:
    """Activate ``plan`` for the dynamic extent of the ``with`` block (works
    for re-activating a plan that is already on the stack)."""
    if not plan.enabled:
        raise RuntimeError("cannot activate the NULL fault plan")
    return _Activation(plan)


# ---------------------------------------------------------------------------
# Schedule files (the committed-chaos-schedule surface)
# ---------------------------------------------------------------------------


def _plan_from_dict(d: Mapping[str, Any]) -> FaultPlan:
    known = {f.name for f in dataclasses.fields(FaultRule)}
    rules = []
    for raw in d.get("rules", []):
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown fault-rule keys {sorted(unknown)} in {raw}")
        rules.append(FaultRule(**raw))
    unregistered = sorted({r.site for r in rules} - set(SITES))
    if unregistered:
        log.warning(
            "fault schedule names unregistered sites %s (typo? known sites: %s)",
            unregistered, sorted(SITES),
        )
    return FaultPlan(rules, seed=int(d.get("seed", 0)))


def load_plan(path: str | pathlib.Path) -> FaultPlan:
    """Load a fault schedule: ``{"seed": N, "rules": [{...}, ...]}``.

    JSON always works; ``.toml`` needs tomllib (py3.11+) or tomli.
    """
    path = pathlib.Path(path)
    if path.suffix == ".toml":
        try:
            import tomllib
        except ImportError:  # pragma: no cover - py3.10 fallback
            import tomli as tomllib
        data = tomllib.loads(path.read_text())
    else:
        data = json.loads(path.read_text())
    return _plan_from_dict(data)


def plan_from_env(environ: Mapping[str, str] | None = None) -> FaultPlan | None:
    """The plan named by ``REPRO_FAULTS``, or ``None`` when unset/empty."""
    env = os.environ if environ is None else environ
    path = env.get(ENV_VAR, "").strip()
    if not path:
        return None
    return load_plan(path)
