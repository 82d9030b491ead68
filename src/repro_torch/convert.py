"""State carried between the reference (JAX) package and the port.

The reference holds uint64 keys under x64 and uint32 keys without it;
the port holds the same bits as int64 or int32.  These functions take and
give plain numpy arrays (`np.asarray` of the reference's arrays), so the
port never imports the reference.  The numpy dtype of a key field selects
the width: a 4-byte array loads as int32 bits, any other as int64 bits,
and each comes back as uint32 or uint64.

  * `reference_arrays` / `from_reference_arrays`: the arrays of a store,
    sketch, dictionary or snapshot as the reference holds them, by field
    name in field order: key fields unsigned, and each scalar counter at
    the reference's dtype (`core.counters`: int64 once a sum under x64
    has updated it).  Reading keeps the dtype of the counters the port
    holds as the reference does, and marks the other int64 counters;
  * `store_from_numpy` / `store_to_numpy`: a store's arrays, by field
    name, in both directions (key fields unsigned on the numpy side);
  * `shard_store_arrays` / `gather_store_arrays`: a whole store's arrays
    cut into rank r's shard of D for `make_distributed_ingest` (its
    slice of each table's rows, the counters replicated), and D shards'
    arrays joined back into the whole store's;
  * `sketch_from_numpy` / `sketch_to_numpy`: the same for a
    `GraphSketch` (`hh_keys` unsigned);
  * `snapshot_to_numpy`: a `GraphSnapshot`'s arrays (`node_key`
    unsigned), to compare with the reference's;
  * `dictionary_from_numpy` / `dictionary_to_numpy`: the same for a
    GraphZip `PatternDictionary` (`sig` and `psig` unsigned);
  * `controller_from_numpy`: the two RLS states (theta, P, n) of a
    `PerfMon.state()` dict, into a port `BufferController`;
  * `bloom_bitmap_from_numpy` / `bloom_bitmap_to_numpy`: a Bloom filter,
    (W, 1024) uint32 on the numpy side, int32 with the same bits here;
  * `lm_params_from_numpy`: the reference's LM parameter tree (nested
    dicts, per-layer leaves stacked on a leading axis) into the port's
    model of the same config;
  * `lm_cache_from_numpy`: the reference's decode cache (prefill's or
    `alloc_cache`'s) into the port's, so the port's decode step can
    continue the reference's prefill.
Float leaves may be bfloat16 (`ml_dtypes` arrays, which numpy cannot
name): they go through float32, exactly, and are cast on the torch side.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.compress.dictionary import PatternDictionary
from repro_torch.configs.base import ModelConfig
from repro_torch.core import counters
from repro_torch.core.buffer import rls_from_numpy
from repro_torch.core.compression import signed_view, unsigned_view
from repro_torch.graphstore.store import GraphStore
from repro_torch.models import model as lm
from repro_torch.models.params import torch_dtype
from repro_torch.query.sketch import GraphSketch
from repro_torch.query.snapshot import GraphSnapshot

KEY_FIELDS = ("node_keys", "edge_keys", "edge_src", "edge_dst", "hh_keys", "node_key",
              "sig", "psig")


def from_reference_arrays(cls, arrays: Mapping[str, np.ndarray], device):
    """A `cls` on `device` from numpy arrays keyed by field name: key
    fields as int32 bits where they are 4-byte (uint32), else as int64
    bits; the counters the port holds at the reference's dtype
    (`core.counters.HELD`) as they arrive, int32 or int64; every other
    field as int32, the scalar counters that arrive as int64 marked so
    (`core.counters`)."""
    wide = []

    def tensor(name):
        a = np.array(arrays[name])  # a contiguous copy; 0-d stays 0-d
        if name in KEY_FIELDS:
            a = signed_view(a.astype(np.uint32 if a.dtype.itemsize == 4 else np.uint64,
                                     copy=False))
        elif a.dtype != np.int32 and name not in counters.HELD:
            if a.ndim == 0 and a.dtype == np.int64:
                wide.append(name)
            a = a.astype(np.int32)
        return torch.from_numpy(a).to(device)

    obj = cls(**{f.name: tensor(f.name) for f in dataclasses.fields(cls)})
    if wide:
        setattr(obj, counters.ATTR, frozenset(wide))
    return obj


def reference_arrays(obj, copy: bool = False) -> Dict[str, np.ndarray]:
    """`obj`'s arrays as the reference holds them (module docstring).
    `copy=True` copies every leaf: on the host `.numpy()` would share
    the live tensor's memory, which the port updates in place."""
    wide = counters.int64_counters(obj)
    out = {}
    for f in dataclasses.fields(obj):
        t = getattr(obj, f.name).detach()
        a = (t.clone() if copy and t.device.type == "cpu" else t).cpu().numpy()
        if f.name in KEY_FIELDS:
            a = unsigned_view(a)
        elif f.name in wide:
            a = a.astype(np.int64)
        out[f.name] = a
    return out



def store_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: Union[str, torch.device] = "cuda") -> GraphStore:
    """A port store on `device` from numpy arrays keyed by field name."""
    return from_reference_arrays(GraphStore, arrays, device)


def store_to_numpy(store: GraphStore) -> Dict[str, np.ndarray]:
    """The port store's arrays as numpy, key fields unsigned."""
    return reference_arrays(store)


def shard_store_arrays(arrays: Mapping[str, np.ndarray], rank: int,
                       n_ranks: int) -> Dict[str, np.ndarray]:
    """Rank `rank`'s shard of D = `n_ranks` of a whole store's arrays
    (`store_to_numpy`'s layout, or the reference's global `GraphStore`):
    the rank-th of D equal slices of each table's rows, as the
    reference's `P("data")` places them, and the scalar counters as they
    are (replicated)."""
    if not 0 <= rank < n_ranks:
        raise ValueError(f"rank {rank} is not in [0, {n_ranks})")
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.ndim:
            if a.shape[0] % n_ranks:
                raise ValueError(f"{name}: {a.shape[0]} rows do not split into {n_ranks} shards")
            per = a.shape[0] // n_ranks
            a = a[rank * per:(rank + 1) * per]
        out[name] = a.copy()
    return out


def gather_store_arrays(shards) -> Dict[str, np.ndarray]:
    """The whole store's arrays from its D shards' (in rank order): the
    tables' slices joined, and the scalar counters, which every shard
    must hold alike (raises otherwise)."""
    out = {}
    for name, first in shards[0].items():
        parts = [np.asarray(s[name]) for s in shards]
        if np.asarray(first).ndim:
            out[name] = np.concatenate(parts)
        else:
            if any(p.dtype != parts[0].dtype or p != parts[0] for p in parts):
                raise ValueError(f"{name} differs between shards: {parts}")
            out[name] = parts[0].copy()
    return out


def sketch_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: Union[str, torch.device] = "cuda") -> GraphSketch:
    """A port sketch on `device` from numpy arrays keyed by field name."""
    return from_reference_arrays(GraphSketch, arrays, device)


def sketch_to_numpy(sketch: GraphSketch) -> Dict[str, np.ndarray]:
    """The port sketch's arrays as numpy, `hh_keys` unsigned."""
    return reference_arrays(sketch)


def snapshot_to_numpy(snap: GraphSnapshot) -> Dict[str, np.ndarray]:
    """The port snapshot's arrays as numpy, `node_key` unsigned."""
    return reference_arrays(snap)


def dictionary_from_numpy(arrays: Mapping[str, np.ndarray],
                          device: Union[str, torch.device] = "cuda") -> PatternDictionary:
    """A port pattern dictionary on `device` from numpy arrays keyed by
    field name."""
    return from_reference_arrays(PatternDictionary, arrays, device)


def dictionary_to_numpy(d: PatternDictionary) -> Dict[str, np.ndarray]:
    """The port dictionary's arrays as numpy, `sig` and `psig` unsigned."""
    return reference_arrays(d)


def bloom_bitmap_from_numpy(bitmap: np.ndarray,
                            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """A port Bloom filter on `device` from a (W, 1024) uint32 bitmap."""
    a = np.ascontiguousarray(np.asarray(bitmap, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def bloom_bitmap_to_numpy(bitmap: torch.Tensor) -> np.ndarray:
    """The port Bloom filter as a (W, 1024) uint32 numpy bitmap."""
    return bitmap.cpu().numpy().view(np.uint32)


def controller_from_numpy(controller, perfmon_state: Mapping) -> None:
    """Load the beta and mu RLS models (theta, P, n) of a
    `PerfMon.state()` dict into `controller.perfmon`."""
    pm = controller.perfmon
    pm.beta_model = rls_from_numpy(perfmon_state["beta_model"], pm.device)
    pm.mu_model = rls_from_numpy(perfmon_state["mu_model"], pm.device)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _float_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy (any float kind, bfloat16 included) -> torch `dtype` through
    float32; the float32 step is exact for bfloat16 and float32 leaves."""
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device, dtype=dtype)


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device: Union[str, torch.device] = "cuda",
                         dtype: Optional[Union[str, torch.dtype]] = None):
    """The port's model of `cfg` on `device` in `dtype` (default
    cfg.dtype) holding the reference's parameters `tree` (its
    `init_params(param_specs(cfg), ...)` as numpy).  Raises if a leaf
    has no parameter, a parameter no leaf, or a shape differs."""
    dt = torch_dtype(dtype or cfg.dtype)
    model = lm.init_params(cfg, device, dtype=dt)
    params = dict(model.named_parameters())
    filled = set()
    for name, a in _flatten(tree):
        a = np.asarray(a)
        if name.startswith("layers."):
            leaves = [(f"layers.{i}.{name[len('layers.'):]}", a[i]) for i in range(a.shape[0])]
        else:
            leaves = [(name, a)]
        for pname, arr in leaves:
            if pname not in params:
                raise KeyError(f"the port's {cfg.arch_id} model has no parameter {pname}")
            p = params[pname]
            if tuple(p.shape) != arr.shape:
                raise ValueError(f"{pname}: shape {arr.shape} != the port's {tuple(p.shape)}")
            p.data.copy_(_float_tensor(arr, dt, p.device))
            filled.add(pname)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no reference leaf for {missing}")
    return model


def lm_cache_from_numpy(cache: Mapping[str, np.ndarray], cfg: ModelConfig,
                        device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """The port's decode cache from the reference's, leaf by leaf, each in
    the dtype the port's `cache_specs` gives it."""
    specs = lm.cache_specs(cfg, 1, 1)
    return {name: _float_tensor(a, torch_dtype(specs[name][1]), device)
            for name, a in cache.items()}
