"""`PipelineCheckpointer`: step-atomic snapshots of the full ingest state.
Counterpart of `repro.resilience.checkpoint`, with its layout:

  <dir>/step_<N>/
    manifest.json            # step, array-leaf index, shapes/dtypes, extra
    <component>.<leaf>.npy   # one file per array leaf
    host.pkl                 # everything else: buffers, cursors, counters
    _COMMITTED               # written last: restore ignores torn checkpoints

Array components are the pipeline's device structures (the `GraphStore`,
the commit-consistent `GraphSketch`es, the `PatternDictionary`), saved one
`.npy` per dataclass field as the reference holds it: leaf
`<component>.<i>` is field i, key fields unsigned, and each scalar
counter at the reference's dtype (`core.counters`), so the files of a
run equal the reference's byte for byte and either package restores the
other's leaves.  The host blob carries the rest through each part's
`state()`/`restore_state()` pair: the record buffer and controller (RLS
models, spill-file contents), the consumer backlog, the MetricsHub trace
and counters, the ingestor's pool and archive, the source cursor and the
loop scalars, all as numpy and plain Python, so a checkpoint taken on
the card restores on the host.  A restore reads the reference's
`host.pkl` too: its classes map from `repro.*` to the port's of the same
name under `repro_torch.*`, and a jax class is refused.

Because every downstream value is counter-deterministic, restoring all
of it makes a resumed `run_scenario` bit-exact against an uninterrupted
run.  The capture is synchronous (a consistent cut; its device-to-host
copies are the only synchronisation a save adds, and on the host every
leaf is copied, since the port updates its tables in place), and a
background thread writes; `wait()` joins before the next save.  Keep-N
GC and `_COMMITTED`-gated discovery as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

from repro_torch import convert
from repro_torch.compress.dictionary import init_dictionary
from repro_torch.resilience.faults import FaultPlan, PipelineKilled
from repro_torch.telemetry.spans import NULL_REGISTRY


def _array_components(pipe) -> Dict[str, Any]:
    """Name -> device structure of everything that snapshots as .npy
    leaves.  Mirrors the builder's wiring: the sink chain's store and
    sketch, plus any sketch or dictionary record stages."""
    out: Dict[str, Any] = {}
    sink = pipe.sink
    ingestor = getattr(sink, "ingestor", None)
    if ingestor is not None:
        out["store"] = ingestor.store
    sketch = getattr(sink, "sketch", None)
    if sketch is not None:
        out["sink_sketch"] = sketch
    for i, st in enumerate(getattr(pipe, "stages", ())):
        if hasattr(st, "sketch"):
            out[f"stage{i}_sketch"] = st.sketch
        if getattr(st, "dct", None) is not None:
            out[f"stage{i}_dict"] = st.dct
    return out


def _component_templates(pipe, saved_keys: Iterable[str]) -> Dict[str, Any]:
    """Like `_array_components`, but also makes templates for components
    a FRESH pipeline builds lazily: the pattern dictionary is created on
    the first rewrite, so a just-built resume pipeline has `dct=None`
    even though the checkpoint holds one.  The template is made on the
    stage's device at the store's key dtype."""
    comp = _array_components(pipe)
    key_dtype = pipe.store.node_keys.dtype
    for i, st in enumerate(getattr(pipe, "stages", ())):
        name = f"stage{i}_dict"
        if (name not in comp and hasattr(st, "capacity")
                and any(k.startswith(name + ".") for k in saved_keys)):
            comp[name] = init_dictionary(st.capacity, st.device, key_dtype=key_dtype)
    return comp


def _assign_components(pipe, restored: Dict[str, Any]) -> None:
    """Hand the restored structures to their holders: the ingestor (the
    one store of every path, sharded included), the query sink, and the
    sketch and dictionary stages.  The snapshot maintainer holds no
    store, and its cache is dropped by the sink's `restore_state`."""
    sink = pipe.sink
    ingestor = getattr(sink, "ingestor", None)
    if "store" in restored and ingestor is not None:
        ingestor.store = restored["store"]
    if "sink_sketch" in restored:
        sink.sketch = restored["sink_sketch"]
    for i, st in enumerate(getattr(pipe, "stages", ())):
        if f"stage{i}_sketch" in restored:
            st.sketch = restored[f"stage{i}_sketch"]
        if f"stage{i}_dict" in restored:
            st.dct = restored[f"stage{i}_dict"]


def pytree_digest(tree) -> str:
    """sha256 over every leaf's dtype, shape and bytes of a store,
    sketch, dictionary or snapshot, field by field: the byte-identity
    witness the chaos harness compares between runs, equal to the
    reference's for the same contents (its leaves as the reference
    holds them, `convert.reference_arrays`)."""
    import hashlib

    h = hashlib.sha256()
    for arr in convert.reference_arrays(tree).values():
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _check_key_width(d: str, key: str, saved: np.ndarray, held) -> None:
    """Refuse a key leaf of another width than the resume pipeline's."""
    if saved.dtype.itemsize != held.element_size():
        raise ValueError(
            f"checkpoint {d} holds {8 * saved.dtype.itemsize}-bit keys ({key}: "
            f"{saved.dtype}), the resume pipeline {8 * held.element_size()}-bit keys "
            f"(key_dtype={held.dtype}): resume at the key width that saved it")


class _HostUnpickler(pickle.Unpickler):
    """Reads a `host.pkl` of either package: a class of the reference
    (`repro.*`) loads as the port's of the same name (`repro_torch.*`),
    whose fields and pickled form agree; jax classes are refused."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"host state holds the jax class {module}.{name}; a checkpoint's host "
                f"state must be numpy and plain Python")
        if root == "repro":
            module = "repro_torch" + module[len("repro"):]
        return super().find_class(module, name)


class PipelineCheckpointer:
    """Periodic step-atomic pipeline snapshots (module docstring)."""

    def __init__(self, directory: str, keep: int = 3, every: int = 16,
                 telemetry=None):
        if every < 1:
            raise ValueError("checkpoint cadence `every` must be >= 1")
        self.dir = directory
        self.keep = keep
        self.every = every
        self.telemetry = telemetry or NULL_REGISTRY
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.saves = 0

    # ------------------------------------------------------------------
    def save(self, step: int, pipe, source=None, blocking: bool = False,
             extra: Optional[Dict] = None) -> None:
        """Capture synchronously (consistent cut), write in background."""
        self.wait()
        tel = self.telemetry
        with tel.span("checkpoint.capture"):
            host_arrays = []
            for name, obj in _array_components(pipe).items():
                for i, arr in enumerate(convert.reference_arrays(obj, copy=True).values()):
                    host_arrays.append((f"{name}.{i}", arr))
            host_state: Dict[str, Any] = {"pipe": pipe.state()}
            if source is not None and hasattr(source, "state"):
                host_state["source"] = source.state()
            blob = pickle.dumps(host_state, protocol=pickle.HIGHEST_PROTOCOL)
        manifest_extra = dict(extra or {})

        def write():
            t0 = time.perf_counter()
            d = os.path.join(self.dir, f"step_{step:08d}")
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": [], "extra": manifest_extra,
                        "host": "host.pkl"}
            for key, arr in host_arrays:
                fn = key.replace("/", "_") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fn, "shape": list(arr.shape),
                     "dtype": str(arr.dtype)})
            with open(os.path.join(tmp, "host.pkl"), "wb") as f:
                f.write(blob)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
            self._gc()
            tel.observe("checkpoint.write", time.perf_counter() - t0)

        self.saves += 1
        tel.count("checkpoint.saved")
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "_COMMITTED")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, pipe, source=None, step: Optional[int] = None,
                expect: Optional[Dict] = None) -> Dict:
        """Load the checkpoint into a freshly BUILT pipeline + source
        (same builder configuration as the saved run) and return the
        manifest.  The leaves load onto the pipeline's device, key
        fields as signed bits of their width and counters as
        `convert.from_reference_arrays` reads them (`core.counters`).  A
        checkpoint whose keys are of another width than the pipeline's
        `key_dtype` is refused, as is an `expect` entry that differs
        from the manifest's `extra` (a scenario, seed or shard
        mismatch): a hard error, not a silently wrong resume."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if expect:
            got = manifest.get("extra", {})
            bad = {k: (got.get(k), v) for k, v in expect.items()
                   if got.get(k) != v}
            if bad:
                raise ValueError(
                    f"checkpoint mismatch in {d}: "
                    + ", ".join(f"{k}: saved={s!r} expected={e!r}"
                                for k, (s, e) in bad.items()))
        tel = self.telemetry
        with tel.span("checkpoint.restore"):
            files = {leaf["key"]: leaf["file"] for leaf in manifest["leaves"]}
            comp = _component_templates(pipe, files.keys())
            restored: Dict[str, Any] = {}
            consumed = set()
            for name, tmpl in comp.items():
                arrays = {}
                for i, f in enumerate(dataclasses.fields(tmpl)):
                    key = f"{name}.{i}"
                    if key not in files:
                        raise KeyError(
                            f"checkpoint {d} lacks leaf {key}: the resume "
                            f"pipeline is configured differently from the "
                            f"saved one")
                    arrays[f.name] = np.load(os.path.join(d, files[key]))
                    consumed.add(key)
                    if f.name in convert.KEY_FIELDS:
                        _check_key_width(d, key, arrays[f.name], getattr(tmpl, f.name))
                device = getattr(tmpl, dataclasses.fields(tmpl)[0].name).device
                restored[name] = convert.from_reference_arrays(type(tmpl), arrays, device)
            orphans = set(files) - consumed
            if orphans:
                raise KeyError(
                    f"checkpoint {d} holds components the resume pipeline "
                    f"does not: {sorted(orphans)[:4]}...")
            _assign_components(pipe, restored)
            with open(os.path.join(d, manifest.get("host", "host.pkl")),
                      "rb") as f:
                host = _HostUnpickler(f).load()
            pipe.restore_state(host["pipe"])
            if source is not None and "source" in host \
                    and hasattr(source, "restore_state"):
                source.restore_state(host["source"])
        return manifest


# ---------------------------------------------------------------------------
# tick driver: checkpoint cadence + crash-at-tick, wrapped around a source
# ---------------------------------------------------------------------------
def drive(source_ticks: Iterable, pipe, source=None,
          checkpointer: Optional[PipelineCheckpointer] = None,
          fault_plan: Optional[FaultPlan] = None, start_tick: int = 0,
          extra: Optional[Dict] = None) -> Iterator:
    """Wrap a tick iterator with periodic checkpoints and the plan's
    crash-at-tick kill.

    The post-yield code runs after the pipeline has FULLY processed the
    yielded tick and before the next one is pulled from the source, so
    a checkpoint's cursor is exact: resume replays from the next tick,
    never re-ingesting or skipping one.  `crash_at_tick` raises
    `PipelineKilled` after the kill tick is processed (a checkpoint due
    at the same tick is written first, durably).
    """
    crash_at = fault_plan.crash_at_tick if fault_plan is not None else None
    tick_no = start_tick
    for tick in source_ticks:
        yield tick
        tick_no += 1
        if checkpointer is not None and tick_no % checkpointer.every == 0:
            hub = getattr(pipe, "metrics", None)
            if hub is not None:
                hub.emit("checkpoint", float(tick_no), step=tick_no)
            checkpointer.save(tick_no, pipe, source, extra=extra)
        if crash_at is not None and tick_no >= crash_at:
            if checkpointer is not None:
                checkpointer.wait()
            raise PipelineKilled(tick_no)
