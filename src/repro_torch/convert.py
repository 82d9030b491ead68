"""State carried between the reference (JAX) package and the port.

The reference's `GraphStore` holds uint64 keys; the port's holds the
same bits as int64.  These functions take and give plain numpy arrays
(`np.asarray` of the reference's arrays), so the port never imports
the reference:

  * `store_from_numpy` / `store_to_numpy`: a store's arrays, by field
    name, in both directions (key fields as uint64 on the numpy side);
  * `controller_from_numpy`: the two RLS states (theta, P, n) of a
    `PerfMon.state()` dict, into a port `BufferController`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.buffer import rls_from_numpy
from repro_torch.graphstore.store import GraphStore

KEY_FIELDS = ("node_keys", "edge_keys", "edge_src", "edge_dst")


def store_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: Union[str, torch.device] = "cuda") -> GraphStore:
    """A port store on `device` from numpy arrays keyed by field name."""
    def tensor(name):
        a = np.array(arrays[name])  # a contiguous copy; 0-d stays 0-d
        if name in KEY_FIELDS:
            a = a.astype(np.uint64, copy=False).view(np.int64)
        elif a.dtype != np.int32:
            a = a.astype(np.int32)
        return torch.from_numpy(a).to(device)

    return GraphStore(**{f.name: tensor(f.name) for f in dataclasses.fields(GraphStore)})


def store_to_numpy(store: GraphStore) -> Dict[str, np.ndarray]:
    """The port store's arrays as numpy, key fields as uint64."""
    out = {}
    for f in dataclasses.fields(GraphStore):
        a = getattr(store, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint64) if f.name in KEY_FIELDS else a
    return out


def controller_from_numpy(controller, perfmon_state: Mapping) -> None:
    """Load the beta and mu RLS models (theta, P, n) of a
    `PerfMon.state()` dict into `controller.perfmon`."""
    pm = controller.perfmon
    pm.beta_model = rls_from_numpy(perfmon_state["beta_model"], pm.device)
    pm.mu_model = rls_from_numpy(perfmon_state["mu_model"], pm.device)
