"""The port stands alone and does not hide the device.

  * Importing every `repro_torch` module loads neither `jax` nor the
    reference package `repro` (checked in a fresh interpreter; the walk
    includes the ops layer: `telemetry.audit`, `telemetry.export`, the
    `monitor`, `lineage` and `resilience` packages, `resilience.checkpoint`
    and `launch.telemetry`/`launch.monitor`/`launch.lineage`/
    `launch.chaos`), and no
    source file under `src/repro_torch` imports either.  Importing
    `launch.mesh` and the distributed ingest's module initialises no
    process group either.
  * Entry points default to the card: without one, a run that did not
    ask for the CPU raises instead of carrying on on the host.
  * `chip_smoke.py` fails, and prints no result, where there is no card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
ops = {"repro_torch.telemetry.audit", "repro_torch.telemetry.export", "repro_torch.monitor",
       "repro_torch.monitor.detectors", "repro_torch.monitor.slo", "repro_torch.monitor.quality",
       "repro_torch.monitor.monitor", "repro_torch.monitor.export",
       "repro_torch.launch.telemetry", "repro_torch.launch.monitor",
       "repro_torch.lineage", "repro_torch.lineage.tracker", "repro_torch.lineage.export",
       "repro_torch.resilience", "repro_torch.resilience.retry",
       "repro_torch.resilience.faults", "repro_torch.launch.lineage",
       "repro_torch.resilience.checkpoint", "repro_torch.launch.chaos"}
assert ops <= set(names), sorted(ops - set(names))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         env=_env(), cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 85 and bad == "[]", out.stdout


_IMPORT_MESH = """
import sys
import torch.distributed as dist
import repro_torch.launch.mesh
import repro_torch.graphstore.store
from repro_torch.graphstore.store import make_distributed_ingest
from repro_torch.launch.mesh import dp_size, make_dev_mesh, make_production_mesh
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(dist.is_initialized(), bad)
"""


def test_importing_the_mesh_module_loads_no_jax_and_starts_no_process_group():
    out = subprocess.run([sys.executable, "-c", _IMPORT_MESH], capture_output=True, text=True,
                         env=_env(), cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False []", out.stdout


def test_no_port_source_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    from repro_torch.launch import ingest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.main(["--ticks", "2"])
    rep, pipe = ingest.main(["--ticks", "3", "--device", "cpu"])
    assert pipe.store.device.type == "cpu" and rep.total_records > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.main(["--ticks", "2", "--shards", "2", "--dict-compress"])
    rep, pipe = ingest.main(["--ticks", "3", "--device", "cpu", "--shards", "2",
                             "--dict-compress"])
    assert pipe.store.device.type == "cpu" and len(rep.shards) == 2 and rep.total_records > 0


def test_query_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch import query

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.main(["--dryrun", "--ticks", "2"])
    out = query.run(["--dryrun", "--device", "cpu", "--mode", "live", "--query-every", "5"])
    assert out.code == 0 and out.snapshot.node_key.device.type == "cpu"
    assert int(out.snapshot.n_edges) > 0 and (out.est_w >= out.exact_w).all()


def test_workload_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch import workload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workload.main(["--dryrun", "--ticks", "2"])
    code, rep = workload.run(["--dryrun", "--ticks", "8", "--device", "cpu", "--dict-compress"])
    assert code == 0 and rep.total_records > 0 and rep.dict_compress
    code, rep = workload.run(["--dryrun", "--ticks", "8", "--device", "cpu", "--shards", "2"])
    assert code == 0 and rep.total_records > 0 and rep.shards == 2


@pytest.mark.parametrize("name", ["telemetry", "monitor", "lineage"])
def test_ops_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch, tmp_path, capsys,
                                                                 name):
    import importlib

    cli = importlib.import_module(f"repro_torch.launch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dryrun", "--ticks", "2"])
    trace = str(tmp_path / "t.json")
    argv = ["--dryrun", "--ticks", "40", "--device", "cpu", "--shards", "2"]
    code, rep = cli.run(argv + (["--trace-out", trace] if name != "monitor" else []))[:2]
    assert code == 0 and rep.total_records > 0 and rep.shards == 2 and rep.telemetry_enabled
    assert rep.monitor_enabled == (name in ("monitor", "lineage"))
    assert rep.lineage_enabled == (name == "lineage")
    assert "dryrun ok" in capsys.readouterr().out


def test_chaos_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch, tmp_path, capsys):
    from repro_torch.launch import chaos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.main(["--dryrun", "--dir", str(tmp_path / "card")])
    code, verdict = chaos.run(["--dryrun", "--device", "cpu", "--dir", str(tmp_path / "host")])
    assert code == 0 and verdict["ok"] and verdict["resumed_from"] == 24
    assert capsys.readouterr().out.endswith("chaos ok\n")


def test_serve_launch_without_a_card_fails_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--gen", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-780m", "--smoke", "--gen", "2"])
    gen = serve.main(["--smoke", "--gen", "2", "--batch", "1", "--device", "cpu"])
    assert gen.shape == (1, 2)


@pytest.mark.parametrize("entry", ["builder", "sink", "transform", "controller",
                                   "sketch_stage", "sketch", "scenario_source",
                                   "dictionary_stage", "run_scenario", "sharded_pipeline",
                                   "compat_pipeline", "bloom_bitmap"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    from repro_torch.api import GraphStoreSink, PipelineBuilder, ShardedPipeline, TransformStage
    from repro_torch.compress import DictionaryStage
    from repro_torch.configs.paper_ingest import IngestConfig
    from repro_torch.core.buffer import BufferController
    from repro_torch.core.pipeline import IngestionPipeline
    from repro_torch.kernels.bloom import init_bitmap
    from repro_torch.query import SketchStage, init_sketch
    from repro_torch.workloads import ScenarioSource, run_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "builder": lambda: PipelineBuilder(IngestConfig()),
        "sink": lambda: GraphStoreSink(node_cap=64, edge_cap=64),
        "transform": lambda: TransformStage(),
        "controller": lambda: BufferController(IngestConfig()),
        "sketch_stage": lambda: SketchStage(),
        "sketch": lambda: init_sketch(),
        "scenario_source": lambda: ScenarioSource("flash_crowd"),
        "dictionary_stage": lambda: DictionaryStage(),
        "run_scenario": lambda: run_scenario("flash_crowd", ticks=2),
        "sharded_pipeline": lambda: ShardedPipeline(IngestConfig(), n_shards=2),
        "compat_pipeline": lambda: IngestionPipeline(IngestConfig()),
        "bloom_bitmap": lambda: init_bitmap(),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
