"""The reference's dtype of a structure's scalar counters.

Under x64 the reference's counter updates promote: `n + jnp.sum(x)` over
an int32 `x` gives int64, so a counter it updates that way is int64 from
its first update on, while a fresh structure holds int32 (and
`build_snapshot`'s `n_nodes`, a sum, is int64 from the start).  Without
x64, where its keys are 32-bit, every counter stays int32.  The counters
that promote, by the function that first updates them:

  * `GraphStore`: `n_nodes`, `n_edges` (`ingest_step`);
  * `GraphSketch`: `n_updates` (`sketch_update`);
  * `PatternDictionary`: `hits`, `misses` (`dict_lookup`); `n_entries`,
    `evictions` (`dict_admit`); `tick` never (it adds a Python 1);
  * `GraphSnapshot`: `n_nodes` (`build_snapshot`, `apply_delta`);
    `n_edges` never (an element of the int32 `indptr`).

The port keeps every counter int32, since its kernels read them.  Each
of those functions instead records, on the structure it returns, which
counters the reference would hold as int64 by then; a checkpoint's leaves
and `pytree_digest` write those counters at int64, and a restore marks
the counters it read at int64.
"""
from __future__ import annotations

from typing import FrozenSet, Iterable

import torch

ATTR = "int64_counters"


def int64_counters(obj) -> FrozenSet[str]:
    """The counters of `obj` the reference holds as int64."""
    return getattr(obj, ATTR, frozenset())


def widen(obj, key: torch.Tensor, names: Iterable[str], base=None):
    """Mark `names` (with those of `base`, the structure `obj` was
    updated from, default `obj` itself) as int64 on `obj` when `key`,
    one of its key fields, is 64-bit; returns `obj`."""
    if key.dtype == torch.int64:
        setattr(obj, ATTR, int64_counters(obj if base is None else base) | frozenset(names))
    return obj
