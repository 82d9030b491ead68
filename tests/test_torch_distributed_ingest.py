"""Port parity: the distributed graph-store ingest
(`make_distributed_ingest`), its mesh helpers (`launch.mesh`) and the
shard helpers of `convert`.

  * The reference runs once, in a subprocess of its own (the only place
    where a host device count is forced, through `XLA_FLAGS` in the
    child's environment): `make_distributed_ingest` over
    `make_dev_mesh(D, 1)` at D = 2 and D = 4, under x64 (uint64 keys)
    and without it (uint32 keys), 3 commits of 1,024 raw edges into a
    2^12-node, 2^13-edge store.  It writes every commit's global store
    and stats to an `.npz`.
  * The port's side runs the same commits through `ingest_ranks` (the D
    ranks in one process, the exchange a transpose of the routed
    buffers) from the shards `convert.shard_store_arrays` cuts, and is
    held bit for bit to the reference after every commit: every table,
    the counters with their dtype (int64 once the reference's x64 sum
    has updated them, `core.counters`), every stat with its dtype.
  * Real gloo worlds of 2 and 4 processes (`torch.multiprocessing.spawn`,
    `file://` rendezvous, no TCP port) run `make_distributed_ingest` over
    `make_dev_mesh` and give the composition's shards and stats; in the
    world of 4, a 2x2 mesh replicates the ingest over its `model`
    dimension.  The workers also check the mesh helpers.
  * The reference's behaviours that the port keeps (ROADMAP F36):
    ownership is the raw source key mod D, lanes that land in another
    rank's slots are dropped without a count, the summed `store_*`
    stats lag the global counters by their remainder mod D, and a node
    lives in every shard that owns one of its edges.
"""
import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import counters
from repro_torch.core.edge_table import build_edge_table
from repro_torch.graphstore import store as PS

ROOT = Path(__file__).resolve().parents[1]
NODE_CAP, EDGE_CAP = 1 << 12, 1 << 13
N_RAW = 1024  # raw edges a commit, over all ranks
COMMITS = 3
N_USERS = 3000
RANKS = (2, 4)
WIDTHS = (64, 32)
GLOO_TIMEOUT_S = 120  # a world's whole run; a collective waits at most 60 s
FIELDS = [f.name for f in dataclasses.fields(PS.GraphStore)]
KEY_DTYPE = {64: torch.int64, 32: torch.int32}

_REFERENCE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.graphstore.store import init_store, make_distributed_ingest
from repro.launch.mesh import make_dev_mesh

inp, out, ncap, ecap = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
data = dict(np.load(inp))
res = {}
for bits in (64, 32):
    with jax.enable_x64(bits == 64):
        kd = np.uint64 if bits == 64 else np.uint32
        for D in (2, 4):
            ingest = jax.jit(make_distributed_ingest(make_dev_mesh(D, 1)))
            store = init_store(ncap, ecap)
            c = 0
            while f"src{c}" in data:
                store, stats = ingest(store, jnp.asarray(data[f"src{c}"].astype(kd)),
                                      jnp.asarray(data[f"dst{c}"].astype(kd)),
                                      jnp.asarray(data[f"etype{c}"]),
                                      jnp.asarray(data[f"valid{c}"]))
                for name in ("node_keys", "node_count", "node_degree", "edge_keys",
                             "edge_src", "edge_dst", "edge_type", "edge_count",
                             "n_nodes", "n_edges"):
                    res[f"{bits}/{D}/{c}/store/{name}"] = np.asarray(getattr(store, name))
                for k, v in stats.items():
                    res[f"{bits}/{D}/{c}/stats/{k}"] = np.asarray(v)
                c += 1
np.savez(out, **res)
"""


def _batches(seed=0, commits=COMMITS, n=N_RAW):
    """Raw commits over N_USERS ids (about half of them >= 2^63, none
    with zero low 32 bits), sources and destinations Zipf-skewed, 10% of
    lanes invalid: the hot sources crowd their owner's slots."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 2**64 - 1, size=2 * N_USERS, dtype=np.uint64)
    ids = np.unique(ids[(ids & np.uint64(0xFFFFFFFF)) != 0])[:N_USERS]
    rng.shuffle(ids)
    out = {}
    for c in range(commits):
        out[f"src{c}"] = ids[(rng.zipf(1.3, n) - 1) % N_USERS]
        out[f"dst{c}"] = ids[(rng.zipf(1.3, n) - 1) % N_USERS]
        out[f"etype{c}"] = rng.integers(0, 3, size=n).astype(np.int32)
        out[f"valid{c}"] = rng.random(n) >= 0.1
    return out


def _lanes(data, c, bits):
    """Commit c's lanes as the port's tensors at `bits`-bit keys."""
    unsigned = np.uint64 if bits == 64 else np.uint32

    def keys(a):
        return torch.from_numpy(convert.signed_view(a.astype(unsigned)).copy())

    return (keys(data[f"src{c}"]), keys(data[f"dst{c}"]), torch.from_numpy(data[f"etype{c}"]),
            torch.from_numpy(data[f"valid{c}"]))


def _empty_shards(bits, n_ranks):
    whole = convert.store_to_numpy(PS.init_store(NODE_CAP, EDGE_CAP, device="cpu",
                                                 key_dtype=KEY_DTYPE[bits]))
    return [convert.store_from_numpy(convert.shard_store_arrays(whole, r, n_ranks), device="cpu")
            for r in range(n_ranks)]


def _stats_numpy(stats):
    return {k: v.numpy().copy() for k, v in stats.items()}


@pytest.fixture(scope="module")
def data():
    return _batches()


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The reference's stores and stats, by "bits/D/commit/...", from
    one subprocess with four host devices."""
    tmp = tmp_path_factory.mktemp("distributed_reference")
    inp, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(inp, **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(inp), str(out), str(NODE_CAP),
                          str(EDGE_CAP)], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def composition(data):
    """The port's `ingest_ranks` at every (bits, D): the gathered store
    and the stats after each commit."""
    out = {}
    for bits in WIDTHS:
        for n_ranks in RANKS:
            shards = _empty_shards(bits, n_ranks)
            for c in range(COMMITS):
                shards, stats = PS.ingest_ranks(shards, *_lanes(data, c, bits))
                out[bits, n_ranks, c] = (
                    convert.gather_store_arrays([convert.store_to_numpy(s) for s in shards]),
                    _stats_numpy(stats))
    return out


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("n_ranks", RANKS)
def test_composition_matches_the_reference_bit_for_bit(reference, composition, bits, n_ranks):
    for c in range(COMMITS):
        store, stats = composition[bits, n_ranks, c]
        tag = f"{bits}/{n_ranks}/{c}"
        for name in FIELDS:
            # strict: the counters' dtype too (int64 under x64 once updated)
            np.testing.assert_array_equal(store[name], reference[f"{tag}/store/{name}"],
                                          err_msg=f"{tag} {name}", strict=True)
        want = {k.split("/")[-1]: v for k, v in reference.items()
                if k.startswith(f"{tag}/stats/")}
        assert set(stats) == set(want)
        for k, w in want.items():
            assert stats[k].dtype == w.dtype and stats[k].tobytes() == w.tobytes(), \
                f"{tag} {k}: {stats[k]!r} against {w!r}"
    # the last commit's tables are really in use
    assert int(store["n_edges"]) > N_RAW // 2 and (store["edge_count"] > 1).any()


def test_reference_shows_the_store_stats_lag_and_repeated_nodes(reference, composition):
    """The summed `store_*` stats equal D x (old // D) + the new count,
    so they lag the global counters by old % D; and batch_nodes counts a
    node once for each shard that holds it."""
    lags = []
    for bits in WIDTHS:
        for n_ranks in RANKS:
            old_nodes = old_edges = 0
            for c in range(COMMITS):
                store, stats = composition[bits, n_ranks, c]
                assert int(stats["store_nodes"]) == int(store["n_nodes"]) - old_nodes % n_ranks
                assert int(stats["store_edges"]) == int(store["n_edges"]) - old_edges % n_ranks
                lags.append(old_edges % n_ranks)
                old_nodes, old_edges = int(store["n_nodes"]), int(store["n_edges"])
            keys = store["node_keys"][store["node_keys"] != 0]
            assert len(keys) == int(store["n_nodes"])
            # a node that two ranks own edges of sits in both shards
            assert len(np.unique(keys)) < len(keys)
    assert any(lags)


def test_foreign_slots_are_dropped_without_a_count():
    """Rank 0 of D = 2 sends 8 lanes, 6 of them owned by rank 0 (even
    sources): only 4 slots go to rank 0, so 2 valid lanes are dropped,
    and no stat counts them."""
    src = torch.tensor([2, 4, 6, 8, 10, 12, 1, 3], dtype=torch.int64)
    dst = torch.arange(101, 109, dtype=torch.int64)
    etype = torch.zeros(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    send = PS.route(src, dst, etype, valid, 2)
    assert send.shape == (2, 4, 4)
    # stable: the first four even sources in order, then the odd ones
    assert send[0, 0].tolist() == [2, 4, 6, 8] and send[1, 0].tolist() == [10, 12, 1, 3]
    assert send[0, 3].tolist() == [1, 1, 1, 1] and send[1, 3].tolist() == [0, 0, 1, 1]
    # rank 1 sends nothing valid; both ranks commit
    idle = PS.route(src + 1, dst, etype, torch.zeros_like(valid), 2)
    shards = _empty_shards(64, 2)
    local = [PS.commit(shards[r], torch.stack([send[r], idle[r]]))[1] for r in range(2)]
    assert [int(s["batch_edges"]) for s in local] == [4, 2]
    assert sum(int(s["dropped_inserts"]) for s in local) == 0
    # the same through ingest_ranks: rank 0's 8 lanes valid, 6 of them kept,
    # rank 1's (odd sources) all invalid
    shards, stats = PS.ingest_ranks(_empty_shards(64, 2), torch.cat([src, src + 1]),
                                    torch.cat([dst, dst]), torch.cat([etype, etype]),
                                    torch.cat([valid, torch.zeros_like(valid)]))
    assert int(stats["batch_edges"]) == 6 and int(stats["dropped_inserts"]) == 0
    assert int(stats["new_edges"]) == 6 and int(shards[0].n_edges) == 6


@pytest.mark.parametrize("bits", WIDTHS)
def test_ownership_is_the_unsigned_source_key_mod_d(bits):
    rng = np.random.default_rng(3)
    top = 2**64 - 1 if bits == 64 else 2**32 - 1
    u = rng.integers(0, top, size=4096, dtype=np.uint64, endpoint=True)
    u[:4] = [0, 1, top, top - 1]
    u = u.astype(np.uint64 if bits == 64 else np.uint32)
    keys = torch.from_numpy(convert.signed_view(u).copy())
    for d in (1, 2, 3, 4, 7, 16):
        np.testing.assert_array_equal(PS.owner(keys, d).numpy(), (u % d).astype(np.int32))


@pytest.mark.parametrize("bits", WIDTHS)
def test_one_rank_equals_ingest_step(data, bits):
    shards = _empty_shards(bits, 1)
    whole = PS.init_store(NODE_CAP, EDGE_CAP, device="cpu", key_dtype=KEY_DTYPE[bits])
    for c in range(COMMITS):
        lanes = _lanes(data, c, bits)
        shards, stats = PS.ingest_ranks(shards, *lanes)
        whole, want = PS.ingest_step(whole, build_edge_table(*lanes))
        for k in ("delta", "nslot", "eslot"):
            want.pop(k)
        assert list(stats) == list(want)
        for k, w in want.items():
            assert stats[k].item() == w.item(), k
        for name in FIELDS:
            assert torch.equal(getattr(shards[0], name), getattr(whole, name)), name
        assert counters.int64_counters(shards[0]) == counters.int64_counters(whole)


def test_n_local_not_a_multiple_of_d_raises():
    src = torch.arange(1, 11, dtype=torch.int64)
    z = torch.zeros(10, dtype=torch.int32)
    v = torch.ones(10, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_local % D"):
        PS.route(src, src, z, v, 4)
    with pytest.raises(ValueError, match="do not split"):
        PS.ingest_ranks(_empty_shards(64, 4), src, src, z, v)
    # 12 raw edges over 4 ranks: 3 a rank, which 4 slots do not divide
    src = torch.arange(1, 13, dtype=torch.int64)
    with pytest.raises(ValueError, match="n_local % D"):
        PS.ingest_ranks(_empty_shards(64, 4), src, src, torch.zeros(12, dtype=torch.int32),
                        torch.ones(12, dtype=torch.bool))


def test_store_shards_round_trip():
    rng = np.random.default_rng(4)
    whole = {name: rng.integers(0, 1000, size=(64 if name.startswith("node") else 128,))
             .astype(np.uint64 if name in ("node_keys", "edge_keys", "edge_src", "edge_dst")
                     else np.int32) for name in FIELDS[:8]}
    whole["n_nodes"], whole["n_edges"] = np.int64(40), np.int32(90)
    for n_ranks in (1, 2, 4):
        shards = [convert.shard_store_arrays(whole, r, n_ranks) for r in range(n_ranks)]
        per = 128 // n_ranks
        for r, shard in enumerate(shards):
            assert shard["node_keys"].shape == (64 // n_ranks,)
            np.testing.assert_array_equal(shard["edge_count"],
                                          whole["edge_count"][r * per:(r + 1) * per])
            assert shard["n_nodes"].dtype == np.int64 and int(shard["n_edges"]) == 90
        back = convert.gather_store_arrays(shards)
        for name in FIELDS:
            np.testing.assert_array_equal(back[name], whole[name], strict=True)
        # the shards load as port stores; the int64 counter comes back marked
        port = convert.store_from_numpy(shards[0], device="cpu")
        assert port.n_nodes.dtype == torch.int32
        assert convert.store_to_numpy(port)["n_nodes"].dtype == np.int64
    with pytest.raises(ValueError, match="split"):
        convert.shard_store_arrays(whole, 0, 3)
    with pytest.raises(ValueError, match="rank"):
        convert.shard_store_arrays(whole, 2, 2)
    shards = [convert.shard_store_arrays(whole, r, 2) for r in range(2)]
    shards[1]["n_edges"] = np.int32(91)
    with pytest.raises(ValueError, match="n_edges differs"):
        convert.gather_store_arrays(shards)


def test_mesh_needs_a_process_group():
    from repro_torch.launch import mesh

    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_dev_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_production_mesh(device="cpu")


# ---------------------------------------------------------------------------
# real gloo worlds
# ---------------------------------------------------------------------------

def _gloo_worker(rank, world, tmp, data):
    """One rank of a gloo world: the mesh helpers' checks, then the
    distributed ingest at both widths over `make_dev_mesh(world, 1)`
    (and, in a world of 4, over a 2x2 mesh), its shard and the stats
    after every commit written to `tmp`."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    checks = {}
    try:
        m = M.make_dev_mesh(world + 4, 1, device="cpu")  # clamped to the world
        checks["dev_mesh"] = (M.mesh_sizes(m), m.mesh_dim_names, M.dp_size(m))
        for multi_pod in (False, True):
            try:
                M.make_production_mesh(multi_pod=multi_pod, device="cpu")
                checks[f"production_{multi_pod}"] = "built"
            except ValueError as e:
                checks[f"production_{multi_pod}"] = str(e)
        if not torch.cuda.is_available():
            try:
                M.make_dev_mesh(world, 1)
                checks["default_device"] = "built"
            except RuntimeError as e:
                checks["default_device"] = str(e)
        meshes = [("line", m)]
        if world == 4:
            square = M.make_dev_mesh(2, 2, device="cpu")
            checks["square"] = (M.mesh_sizes(square), M.dp_size(square))
            meshes.append(("square", square))
        out = {}
        for label, mesh in meshes:
            d = M.dp_size(mesh)
            coord = mesh.get_coordinate()
            ingest = PS.make_distributed_ingest(mesh)
            for bits in WIDTHS:
                shard = _empty_shards(bits, d)[coord[0]]
                for c in range(COMMITS):
                    src, dst, etype, valid = _lanes(data, c, bits)
                    n = src.shape[0] // d
                    cut = slice(coord[0] * n, (coord[0] + 1) * n)
                    shard, stats = ingest(shard, src[cut], dst[cut], etype[cut], valid[cut])
                    tag = f"{label}/{bits}/{c}"
                    for name, a in convert.store_to_numpy(shard).items():
                        out[f"{tag}/store/{name}"] = a.copy()
                    for k, v in stats.items():
                        out[f"{tag}/stats/{k}"] = v.numpy().copy()
            try:  # d + 1 raw edges a rank: d slots do not divide them
                ingest(shard, *(t[:d + 1] for t in _lanes(data, 0, 64)))
                checks[f"{label}_uneven"] = "ran"
            except ValueError as e:
                checks[f"{label}_uneven"] = str(e)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"checks{rank}.pkl"), "wb") as f:
            pickle.dump(checks, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", RANKS)
def test_gloo_world_gives_the_composition(data, composition, tmp_path, world):
    import torch.multiprocessing as mp

    ctx = mp.spawn(_gloo_worker, args=(world, str(tmp_path), data), nprocs=world, join=False)
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    while not ctx.join(timeout=1):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo world of {world} did not finish in {GLOO_TIMEOUT_S} s")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    checks = []
    for r in range(world):
        with open(tmp_path / f"checks{r}.pkl", "rb") as f:
            checks.append(pickle.load(f))
    for ch in checks:
        sizes, names, dp = ch["dev_mesh"]
        assert sizes == {"data": world, "model": 1} and names == ("data", "model") and dp == world
        assert "needs 256 ranks" in ch["production_False"]
        assert "needs 512 ranks" in ch["production_True"]
        assert "n_local % D" in ch["line_uneven"]
        if not torch.cuda.is_available():
            assert "no CUDA device" in ch["default_device"]
        if world == 4:
            assert ch["square"] == ({"data": 2, "model": 2}, 2)
    layouts = [("line", world, list(range(world)))]
    if world == 4:
        # rank 2 d + m sits at data coordinate d, model coordinate m
        layouts.append(("square", 2, [0, 0, 1, 1]))
    for label, d, data_coord in layouts:
        for bits in WIDTHS:
            for c in range(COMMITS):
                tag = f"{label}/{bits}/{c}"
                want_store, want_stats = composition[bits, d, c]
                for m in range(world // d):
                    col = [ranks[r] for r in range(world) if r % (world // d) == m]
                    assert [data_coord[r] for r in range(world) if r % (world // d) == m] \
                        == list(range(d))
                    got = convert.gather_store_arrays(
                        [{name: rk[f"{tag}/store/{name}"] for name in FIELDS} for rk in col])
                    for name in FIELDS:
                        np.testing.assert_array_equal(got[name], want_store[name],
                                                      err_msg=f"{tag} {name}", strict=True)
                for rk in ranks:
                    for k, w in want_stats.items():
                        g = rk[f"{tag}/stats/{k}"]
                        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{tag} {k}"
