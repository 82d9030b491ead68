"""The four ingestion protocols (structural typing, no registration).
Counterpart of `repro.api.protocols`.

Any object matching the shape plugs in: the pipeline never isinstance-
checks beyond these `runtime_checkable` protocols.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.ingest.sources import StreamTick


@dataclasses.dataclass
class TickContext:
    """Per-tick state handed to stages (time base + loop position)."""

    t: float  # stream time of this tick
    dt: float  # tick duration (s)
    index: int  # tick number within the run


@runtime_checkable
class Source(Protocol):
    """A stream of `StreamTick`s (`BurstyTweetSource`, `FileReplaySource`)."""

    def ticks(self) -> Iterator[StreamTick]: ...


@runtime_checkable
class Stage(Protocol):
    """A per-tick record processor (filter/enrich/split)."""

    name: str

    def __call__(self, records: List[dict], ctx: Optional[TickContext] = None) -> List[dict]: ...


@runtime_checkable
class Transform(Protocol):
    """Model transformation + graph compression: records -> device
    edge table plus the instruction counters (compressed, raw)."""

    name: str

    def encode(self, records: List[dict]) -> Tuple[object, int, int]: ...


@runtime_checkable
class Consumer(Protocol):
    """Load model of the store engine.  `consume` absorbs a commit of
    `instructions` over `dt` seconds and returns the occupancy mu in
    [0,1]; `delay_s` is the system-delay alpha (Eq. 3)."""

    def consume(self, instructions: int, dt: float, now: Optional[float] = None) -> float: ...

    @property
    def delay_s(self) -> float: ...


@runtime_checkable
class Sink(Protocol):
    """Commit target (Algorithm 3 GRAPHPUSH or any store binding).
    Returns the commit stats dict: at minimum `committed`, plus `rho`
    (bucket diversity) when the commit landed."""

    def commit(self, et, now: Optional[float] = None) -> Dict: ...
