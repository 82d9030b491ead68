"""The reference's dtype of a structure's scalar counters.

Under x64 the reference's counter updates promote: `n + jnp.sum(x)` over
an int32 `x` gives int64, so a counter it updates that way is int64 from
its first update on, while a fresh structure holds int32 (and
`build_snapshot`'s `n_nodes`, a sum, is int64 from the start).  Without
x64, where its keys are 32-bit, every counter stays int32 and wraps at
2^31.  The counters that promote, by the function that first updates
them:

  * `GraphStore`: `n_nodes`, `n_edges` (`ingest_step`);
  * `GraphSketch`: `n_updates` (`sketch_update`);
  * `PatternDictionary`: `hits`, `misses` (`dict_lookup`); `n_entries`,
    `evictions` (`dict_admit`); `tick` never (it adds a Python 1);
  * `GraphSnapshot`: `n_nodes` (`build_snapshot`, `apply_delta`);
    `n_edges` never (an element of the int32 `indptr`).

The port holds the counters that no bound keeps below 2^31 as the
reference does (`HELD`: the sketch's `n_updates`, the dictionary's
`hits`, `misses` and `evictions`): their updates add a sum of
`sum_dtype(key)`, int64 where the structure's keys are 64-bit, so they
turn int64 on their first update and never wrap there, and stay int32
at 32-bit keys.  The others are bounded by a capacity (the store's and
the snapshot's `n_nodes` and `n_edges` by the caps, the dictionary's
`n_entries` by its slots) and stay int32, since K1's probe budget reads
the store's.  Each function that updates one of those records, on the
structure it returns, which of them the reference would hold as int64 by
then; a checkpoint's leaves and `pytree_digest` write those at int64,
and a restore marks the ones it read at int64.
"""
from __future__ import annotations

from typing import FrozenSet, Iterable

import torch

ATTR = "int64_counters"

# counters held at the reference's dtype in memory, by field name
HELD = frozenset({"n_updates", "hits", "misses", "evictions"})


def sum_dtype(key: torch.Tensor) -> torch.dtype:
    """The dtype of the reference's `jnp.sum` over int32 at the width of
    `key`, one of a structure's key fields: int64 under x64 (64-bit
    keys), else int32."""
    return torch.int64 if key.dtype == torch.int64 else torch.int32


def int64_counters(obj) -> FrozenSet[str]:
    """The int32 counters of `obj` the reference holds as int64."""
    return getattr(obj, ATTR, frozenset())


def widen(obj, key: torch.Tensor, names: Iterable[str], base=None):
    """Mark `names` (with those of `base`, the structure `obj` was
    updated from, default `obj` itself) as int64 on `obj` when `key`,
    one of its key fields, is 64-bit; returns `obj`."""
    if key.dtype == torch.int64:
        setattr(obj, ATTR, int64_counters(obj if base is None else base) | frozenset(names))
    return obj
