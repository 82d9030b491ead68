"""Device-resident pattern dictionary (GraphZip's frequent-pattern set).
Counterpart of `repro.compress.dictionary`.

A fixed-capacity open-addressing table over edge signatures: an entry
is one member edge of a mined pattern, keyed by its `mix_keys(src, dst,
etype)` signature, with the pattern signature that admitted it (`psig`)
and the store slots the edge and its endpoints were committed to.  A
later batch holding the same edge resolves it to a `(pattern_id,
bindings)` reference: the binding is the cached slot triple, so the
commit applies it by direct scatter instead of re-probing.

Lifecycle (counter-deterministic: no wall clock, no RNG):
  * `dict_lookup` per batch: probe every dedup'd edge key; hits bump
    `refcount` and stamp `clock` with the dictionary tick, which
    advances once per batch.
  * `dict_admit` after a successful commit: insert the batch's
    pattern-member residual edges through the store's own fused upsert
    sweep (`kernels.upsert.fused_upsert`: the kernel on the card).
  * eviction inside `dict_admit`: past the high-water mark, entries idle
    for more than `ttl` ticks are cleared.  An entry behind a cleared
    slot stops being found (a miss, never a wrong hit).

Both functions return a new `PatternDictionary` and leave the one they
were given as it was; `dict_admit` sweeps its own copy of the
signature table in place.

Signatures are int64 (uint64 bits) or int32 (uint32 bits), by
`init_dictionary(..., key_dtype=)`; keys looked up or admitted must be
of that width.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.compression import check_key_dtype
from repro_torch.core.counters import sum_dtype, widen
from repro_torch.device import resolve
from repro_torch.kernels.upsert import fused_upsert, probe_hash

DICT_PROBES = 16  # fixed probe budget (table never exceeds high water)


@dataclasses.dataclass
class PatternDictionary:
    """Fixed-capacity signature table + payload + LRU bookkeeping."""

    sig: torch.Tensor        # (C,) key bits (int64 or int32); 0 = empty slot
    psig: torch.Tensor       # (C,) mined pattern signature (lineage), sig's width
    eslot: torch.Tensor      # (C,) int32 cached store edge slot
    sslot: torch.Tensor      # (C,) int32 cached store slot of src node
    dslot: torch.Tensor      # (C,) int32 cached store slot of dst node
    refcount: torch.Tensor   # (C,) int32 lifetime reference hits
    clock: torch.Tensor      # (C,) int32 dictionary tick of last touch (LRU)
    tick: torch.Tensor       # 0-d int32, advances once per lookup batch
    n_entries: torch.Tensor  # 0-d int32 live entries
    hits: torch.Tensor       # 0-d cumulative reference hits (core.counters)
    misses: torch.Tensor     # 0-d cumulative lookup misses (core.counters)
    evictions: torch.Tensor  # 0-d cumulative aged-out entries (core.counters)

    @property
    def capacity(self) -> int:
        return self.sig.shape[0]

    def load(self) -> float:
        return int(self.n_entries) / max(self.capacity, 1)

    def hit_rate(self) -> float:
        total = int(self.hits) + int(self.misses)
        return int(self.hits) / max(total, 1)


def init_dictionary(capacity: int,
                    device: Union[str, torch.device] = "cuda",
                    key_dtype: torch.dtype = torch.int64) -> PatternDictionary:
    """An empty dictionary of `capacity` slots on `device` for
    `key_dtype` signatures."""
    dev = resolve(device)
    kd = check_key_dtype(key_dtype)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PatternDictionary(
        sig=z(capacity, kd), psig=z(capacity, kd),
        eslot=z(capacity, torch.int32), sslot=z(capacity, torch.int32),
        dslot=z(capacity, torch.int32), refcount=z(capacity, torch.int32),
        clock=z(capacity, torch.int32), tick=z((), torch.int32),
        n_entries=z((), torch.int32), hits=z((), torch.int32),
        misses=z((), torch.int32), evictions=z((), torch.int32),
    )


def _set_at(table: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
            values: torch.Tensor) -> torch.Tensor:
    """A copy of `table` with table[slot] = values where mask, without a
    host sync: masked lanes write a trash slot past the end, which is cut
    off (the reference scatters them to the dropped index C).  Unmasked
    slots must be distinct."""
    cap = table.shape[0]
    ext = torch.cat([table, table.new_zeros(1)])
    idx = torch.where(mask, slot, torch.full_like(slot, cap)).to(torch.int64)
    return ext.index_put_((idx,), values.to(table.dtype).expand_as(idx))[:cap]


def dict_lookup(d: PatternDictionary, keys: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[PatternDictionary, torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Read-mostly probe of unique batch keys (one tick of the clock).

    Returns (d', hit, eslot, sslot, dslot, entry): the per-key hit mask,
    the cached slot payload (-1 where missed) and the dictionary entry
    index (the reference's pattern id, -1 where missed).  Probing stops
    at the first empty slot of a key's sequence."""
    cap, n = d.sig.shape[0], keys.shape[0]
    slot = torch.full((n,), -1, dtype=torch.int32, device=keys.device)
    done = ~valid
    for i in range(DICT_PROBES):
        cand = probe_hash(keys, cap, i)
        cur = d.sig[cand]
        hit = (cur == keys) & ~done
        slot = torch.where(hit, cand.to(torch.int32), slot)
        done = done | hit | (cur == 0)
    hit = valid & (slot >= 0)
    sd = sum_dtype(d.sig)
    # missed lanes add 0 to slot 0; hit slots are distinct (one key per slot)
    refcount = d.refcount.index_add(0, torch.where(hit, slot, 0).to(torch.int64),
                                    hit.to(torch.int32))
    clock = _set_at(d.clock, slot, hit, d.tick)
    d2 = dataclasses.replace(
        d, refcount=refcount, clock=clock, tick=d.tick + 1,
        hits=d.hits + hit.sum(dtype=sd),
        misses=d.misses + (valid & ~hit).sum(dtype=sd))
    widen(d2, d.sig, (), base=d)  # keeps n_entries' mark (core.counters)
    safe =slot.clamp(0, cap - 1).to(torch.int64)
    minus1 = torch.full_like(slot, -1)

    def g(a):
        return torch.where(hit, a[safe], minus1)

    return d2, hit, g(d.eslot), g(d.sslot), g(d.dslot), torch.where(hit, slot, minus1)


def dict_admit(d: PatternDictionary, keys: torch.Tensor, admit: torch.Tensor,
               eslot: torch.Tensor, sslot: torch.Tensor, dslot: torch.Tensor,
               psig: torch.Tensor, ttl: int = 64,
               high_water: float = 0.85) -> PatternDictionary:
    """Insert committed pattern-member edges (unique keys + payload).

    Runs the aging eviction first when occupancy is past the high-water
    mark: entries idle for more than `ttl` dictionary ticks are cleared.
    Then the fused upsert sweep places the admitted keys; present keys
    are refreshed, new keys take their payload."""
    cap = d.sig.shape[0]
    over = d.n_entries > int(high_water * cap)
    stale = (d.sig != 0) & (d.clock + ttl < d.tick)
    evict = stale & over
    # a fresh table: the sweep updates it in place
    sig = torch.where(evict, torch.zeros_like(d.sig), d.sig)
    n_evicted = evict.sum(dtype=torch.int32)
    refcount = torch.where(evict, torch.zeros_like(d.refcount), d.refcount)

    sig, slot, is_new = fused_upsert(sig, keys, admit, DICT_PROBES)
    placed = admit & (slot >= 0)
    new = is_new & admit
    clock = torch.where(evict, torch.zeros_like(d.clock), d.clock)
    out = dataclasses.replace(
        d,
        sig=sig,
        psig=_set_at(d.psig, slot, new, psig),
        eslot=_set_at(d.eslot, slot, new, eslot),
        sslot=_set_at(d.sslot, slot, new, sslot),
        dslot=_set_at(d.dslot, slot, new, dslot),
        refcount=_set_at(refcount, slot, new, torch.ones_like(slot)),
        clock=_set_at(clock, slot, placed, d.tick),
        n_entries=d.n_entries - n_evicted + new.sum(dtype=torch.int32),
        evictions=d.evictions + n_evicted.to(sum_dtype(d.sig)),
    )
    return widen(out, d.sig, ("n_entries",), base=d)  # core.counters
