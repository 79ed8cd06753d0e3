"""The benchmark's host spans around its calls into the program: name, start
and end on the host clock, and what the call worked on.  In a traced run
each span is also a ``record_function`` range named ``bench.<name>``, so the
device trace can say which host span was open during an idle gap."""

from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.records: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        rec = Span(name, time.perf_counter(), meta=dict(meta))
        if self.traced:
            from torch.profiler import record_function

            with record_function(f"bench.{name}"):
                yield rec
        else:
            yield rec
        rec.end = time.perf_counter()
        self.records.append(rec)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.records if s.name == name]
