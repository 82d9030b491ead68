"""Port parity at 32-bit keys: the reference's default width.

Without x64 the reference keys its graph with uint32: `from_raw_batch`
keeps the low 32 bits of each id, `mix_keys` is a 32-bit hash, and the
store's probe multiplies by 0x9E3779B9 in uint32.  The port holds such a
key as a `torch.int32` tensor of the same bits, chosen by `key_dtype=`.
Every reference object here is built inside `jax.enable_x64(False)`, and
every comparison is bit for bit:

  * the helpers: `mix_keys` (with keys that hash onto the sentinel and
    onto 0), `dedup_with_counts`, `from_raw_batch`'s truncation of wide
    ids, `probe_hash`, and the sketch's `node_hash` and `sketch_update`;
  * the plain versions of K1 (`fused_upsert_ref`: a small loaded table,
    contended claims, a budget that drops lanes) and K5
    (`pattern_mine_ref`), against the reference's jnp oracles and its
    Pallas kernels in interpret mode;
  * the slice as a whole: the uncontrolled ingest loop with the query
    sink and GraphZip compression on, through `PipelineBuilder(...,
    key_dtype=torch.int32)` on the CPU against `repro.api` at uint32:
    records, commits, store, both sketches' arrays, the served snapshot
    and the dictionary.  The 64-bit port run of the same loop differs
    (its store holds more nodes and drops fewer lanes), which shows the
    width is in play; `convert` carries the reference's uint32 state in
    and out unchanged, and a 32-bit batch survives the archive spill.

One reference loop run, about 45 s of the file's time on a CPU: 40
ticks, as the two widths' stores still hold equal counts at 24.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PipelineBuilder as RefBuilder
from repro.configs.paper_ingest import IngestConfig as RefIngestConfig
from repro.core import compression as RC
from repro.core.edge_table import from_raw_batch as ref_from_raw
from repro.core.transform import RawEdgeBatch as RefRawEdgeBatch
from repro.ingest.sources import BurstyTweetSource as RefSource
from repro.kernels import pattern_mine as RM
from repro.kernels import upsert as RU
from repro.query import sketch as RQ
from repro_torch import convert
from repro_torch.api import PipelineBuilder
from repro_torch.compress import dictionary as PD
from repro_torch.configs.paper_ingest import IngestConfig
from repro_torch.core import compression as C
from repro_torch.core.edge_table import from_raw_batch
from repro_torch.core.ingestor import GraphIngestor
from repro_torch.core.transform import RawEdgeBatch
from repro_torch.graphstore import store as PS
from repro_torch.ingest.sources import BurstyTweetSource
from repro_torch.kernels import build
from repro_torch.kernels import pattern_mine as PM
from repro_torch.kernels import sketch as PK
from repro_torch.kernels import upsert as PU
from repro_torch.query import sketch as PQ

TICKS = 40
CAPS = dict(store_nodes=1 << 12, store_edges=1 << 14)
QS = dict(depth=4, width=256)
STAR_MIN, HOT_MIN = 4, 2
M32 = (1 << 32) - 1


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, uint32 keys as int32 bits."""
    return torch.from_numpy(C.signed_view(np.ascontiguousarray(a)).copy())


def _same(got: torch.Tensor, want: np.ndarray, msg: str):
    """Bit-equal where `want` holds keys of got's width (uint32 against
    int32), value-equal otherwise."""
    g = got.numpy()
    if want.dtype.kind == "u" and g.dtype.itemsize == want.dtype.itemsize:
        g = C.unsigned_view(g)
    np.testing.assert_array_equal(g, want, err_msg=msg)


def _ref(fn, *args, **kw):
    """The reference's `fn` at uint32 on numpy arguments, as numpy."""
    with jax.enable_x64(False):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        return jax.tree_util.tree_map(np.asarray, out)


def _ids(rng, k):
    """k distinct nonzero uint32 ids, with 0 and 2^32 - 1 among them."""
    ids = np.unique(rng.integers(1, M32, size=2 * k, dtype=np.uint64)).astype(np.uint32)
    rng.shuffle(ids)
    ids[:2] = [0, M32]
    return ids[:k]


# ---------------------------------------------------------------- the helpers


def _onto(rng, n, target):
    """n (src, dst, etype) triples whose 32-bit hash before the remap is
    `target`: etype is chosen to carry the last add there."""
    src = rng.integers(0, M32, n, dtype=np.uint64).astype(np.uint32)
    dst = rng.integers(0, M32, n, dtype=np.uint64).astype(np.uint32)
    x = (src.astype(np.uint64) * 0x9E3779B9 + dst) & M32
    x = ((x ^ (x >> 30)) * 0x85EBCA6B) & M32
    x = x ^ (x >> 27)
    et = ((target - x) & M32).astype(np.uint32).view(np.int32)
    return src, dst, et


def test_mix_keys_and_dedup_match_reference_at_32_bits():
    rng = np.random.default_rng(0)
    n = 4096
    pool = _ids(rng, 600)
    src, dst = pool[rng.integers(0, 600, n)], pool[rng.integers(0, 600, n)]
    et = rng.integers(-2, 300, n).astype(np.int32)
    # lanes that hash onto the sentinel and onto 0 before the remap
    for lo, target in ((0, M32), (8, 0)):
        s, d, e = _onto(rng, 8, target)
        src[lo:lo + 8], dst[lo:lo + 8], et[lo:lo + 8] = s, d, e
    want = _ref(RC.mix_keys, src, dst, et)
    assert want.dtype == np.uint32
    got = C.mix_keys(_t(src), _t(dst), _t(et))
    assert got.dtype == torch.int32
    _same(got, want, "mix_keys")
    assert (want[:8] == M32 - 1).all() and (want[8:16] == 2).all()

    keys = np.concatenate([want[: n // 2], want[: n // 4]])  # duplicates
    valid = rng.random(keys.size) >= 0.1
    rd = _ref(RC.dedup_with_counts, keys, valid)
    pd = C.dedup_with_counts(_t(keys), torch.from_numpy(valid))
    for f in dataclasses.fields(pd):
        _same(getattr(pd, f.name), getattr(rd, f.name), f.name)
    assert int(pd.n_unique) < int(pd.n_input)


def test_from_raw_batch_keeps_the_low_32_bits_as_the_reference():
    rng = np.random.default_rng(1)
    n, cap = 200, 256
    ids = rng.integers(1, 2**64 - 1, size=64, dtype=np.uint64)
    ids[0] = 0x1234567890ABCDEF
    src, dst = ids[rng.integers(0, 64, n)], ids[rng.integers(0, 64, n)]
    src[0] = ids[0]
    et = rng.integers(0, 3, n).astype(np.int32)
    z = np.zeros(n, np.int32)
    with jax.enable_x64(False):
        want = jax.tree_util.tree_map(np.asarray, ref_from_raw(
            RefRawEdgeBatch(src, dst, et, z, z, n), cap))
    got = from_raw_batch(RawEdgeBatch(src, dst, et, z, z, n), cap, device="cpu",
                         key_dtype=torch.int32)
    assert got.src.dtype == torch.int32 and want.src.dtype == np.uint32
    for f in dataclasses.fields(got):
        _same(getattr(got, f.name), getattr(want, f.name), f.name)
    assert 0x90ABCDEF in C.unsigned_view(got.node_ids.numpy())


# ---------------------------------------------------------------- K1's plain version

CAP, LANES = 256, 128


def _upsert_case(seed):
    """A 256-slot table loaded past 0.6 by the reference's own sweep, and
    128 unique keys: a third present, the rest new, 10% invalid, key 0
    among them."""
    rng = np.random.default_rng(seed)
    pool = _ids(rng, 2 * CAP)
    pool = pool[pool != 0]
    m = int(0.65 * CAP)
    table, slot, _ = _ref(RU.fused_upsert_ref, np.zeros(CAP, np.uint32), pool[:m],
                          np.ones(m, bool), 1 << 10)
    assert (slot >= 0).all()
    keys = np.concatenate([pool[: LANES // 3], pool[m:m + LANES - LANES // 3 - 1],
                           np.zeros(1, np.uint32)])[rng.permutation(LANES)]
    return table, keys, rng.random(LANES) >= 0.1


def test_probe_hash_matches_reference_at_32_bits():
    keys = _ids(np.random.default_rng(2), 4096)
    for cap in (7, CAP, 1 << 20):
        for i in (0, 1, 127, 2**31 - 1):
            want = _ref(RU.probe_hash, keys, cap, jnp.full(keys.shape, i, jnp.int32))
            np.testing.assert_array_equal(PU.probe_hash(_t(keys), cap, i).numpy(), want,
                                          err_msg=f"cap={cap} i={i}")


@pytest.mark.parametrize("probes", [2, 64])
def test_fused_upsert_ref_matches_pallas_and_oracle_at_32_bits(probes):
    table, keys, valid = _upsert_case(3)
    pallas = _ref(RU.fused_upsert, table, keys, valid, jnp.int32(probes), interpret=True)
    oracle = _ref(RU.fused_upsert_ref, table, keys, valid, jnp.int32(probes))
    before = dict(build.launches)
    got = PU.fused_upsert(_t(table), _t(keys), torch.from_numpy(valid), probes)
    assert dict(build.launches) == before  # a CPU table runs the plain version
    for name, g, o, w in zip(("table", "slot", "is_new"), got, oracle, pallas):
        np.testing.assert_array_equal(o, w, err_msg=f"oracle {name}")
        _same(g, w, f"port {name}")
    slot, new = pallas[1], pallas[2]
    assert new.any() and (slot[valid & ~new] >= 0).any()  # claims and hits
    if probes == 2:
        assert (slot[valid] < 0).any()  # the budget drops lanes


def test_fused_upsert_refuses_a_table_and_keys_of_two_widths():
    with pytest.raises(TypeError):
        PU.fused_upsert(torch.zeros(64, dtype=torch.int32), torch.ones(4, dtype=torch.int64),
                        torch.ones(4, dtype=torch.bool), 8)


# ---------------------------------------------------------------- K5's plain version


def _mine_batch(rng, n):
    """Star bursts, chains and hot edges among random edges over uint32
    ids (0 and 2^32 - 1 among them), with invalid lanes."""
    ids = _ids(rng, max(n // 4, 8))
    src, dst = ids[rng.integers(0, ids.size, n)], ids[rng.integers(0, ids.size, n)]
    et = rng.integers(0, 3, n).astype(np.int32)
    count = rng.integers(1, 4, n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    src[: n // 8], et[: n // 8] = ids[2], 1  # a hub
    dst[n // 8: n // 4] = src[n // 4: 3 * n // 8]  # chains
    count[-4:] = HOT_MIN + 2
    return src, dst, et, count, valid


@pytest.mark.parametrize("n", [64, 1024])
def test_pattern_mine_ref_matches_pallas_and_oracle_at_32_bits(n):
    batch = _mine_batch(np.random.default_rng(n), n)
    oracle = _ref(RM.pattern_mine_ref, *batch, STAR_MIN, HOT_MIN)
    pallas = _ref(RM.pattern_mine, *batch, STAR_MIN, HOT_MIN, interpret=True)
    got = PM.pattern_mine(*(_t(a) for a in batch), STAR_MIN, HOT_MIN)
    assert got[3].dtype == torch.int32 and oracle[3].dtype == np.uint32
    for name, g, o, w in zip(("fan_out", "fan_in", "flags", "psig"), got, oracle, pallas):
        np.testing.assert_array_equal(o, w, err_msg=f"oracle {name}")
        _same(g, w, f"port {name}")
    flags = oracle[2]
    for bit in (PM.FLAG_STAR_OUT, PM.FLAG_CHAIN, PM.FLAG_HOT):
        assert (flags & bit).any(), bit


# ---------------------------------------------------------------- the sketch


def test_node_hash_and_sketch_update_match_reference_at_32_bits():
    rng = np.random.default_rng(4)
    keys = _ids(rng, 4096)
    want = _ref(RQ.node_hash, keys, 4, 256)
    np.testing.assert_array_equal(PK.node_hash(_t(keys), 4, 256).numpy(), want)

    with jax.enable_x64(False):
        rsk = RQ.init_sketch(depth=4, width=256, hh_slots=16)
    psk = PQ.init_sketch(depth=4, width=256, hh_slots=16, device="cpu", key_dtype=torch.int32)
    ids = rng.integers(1, 2**64 - 1, size=300, dtype=np.uint64)
    for b in range(4):
        n = int(rng.integers(100, 250))
        src, dst = ids[rng.integers(0, 300, n)], ids[rng.integers(0, 300, n)]
        et, z = rng.integers(0, 3, n).astype(np.int32), np.zeros(n, np.int32)
        with jax.enable_x64(False):
            rsk = RQ.sketch_update(rsk, ref_from_raw(RefRawEdgeBatch(src, dst, et, z, z, n), 256))
        psk = PQ.sketch_update(psk, from_raw_batch(RawEdgeBatch(src, dst, et, z, z, n), 256,
                                                   device="cpu", key_dtype=torch.int32))
        got = convert.sketch_to_numpy(psk)
        for name, g in got.items():
            np.testing.assert_array_equal(g, np.asarray(getattr(rsk, name)),
                                          err_msg=f"batch {b}: {name}")
    assert got["hh_keys"].dtype == np.uint32 and (got["hh_keys"] != 0).any()


# ---------------------------------------------------------------- the slice as a whole


def _loop(builder, tmp, name):
    return (builder.uncontrolled().with_query_sink(**QS).with_compression()
            .spill_dir(str(tmp / name)))


def _fields(obj) -> dict:
    """A reference dataclass's arrays as numpy, by field name."""
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uncontrolled loop with the query sink and GraphZip on: the
    reference at uint32, the port at 32 and at 64 bits, on the CPU."""
    tmp = tmp_path_factory.mktemp("keys32")
    with jax.enable_x64(False):
        b = RefBuilder(RefIngestConfig(**CAPS)).with_source(RefSource(seed=0))
        b = _loop(b, tmp, "ref")
        pipe = b.build()
        rep = pipe.run(max_ticks=TICKS)
        ref = dict(rep=rep, commits=pipe.sink.ingestor.commits,
                   store=_fields(pipe.store), sketch=_fields(pipe.sink.sketch),
                   snapshot=_fields(pipe.sink.snapshot()),
                   dictionary=_fields(b.dictionary_stage.dct))
    port = {}
    for kd in (torch.int32, torch.int64):
        b = PipelineBuilder(IngestConfig(**CAPS), device="cpu", key_dtype=kd)
        b = _loop(b.with_source(BurstyTweetSource(seed=0)), tmp, f"port{kd}")
        pipe = b.build()
        port[kd] = dict(rep=pipe.run(max_ticks=TICKS), commits=pipe.sink.ingestor.commits,
                        pipe=pipe, dictionary=b.dictionary_stage.dct)
    return ref, port


def _assert_arrays_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, w in want.items():
        assert got[name].dtype == w.dtype, f"{what}.{name}: {got[name].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[name], w, err_msg=f"{what}.{name}")


def test_32_bit_loop_matches_reference_exactly(runs):
    ref, port = runs
    got = port[torch.int32]
    grep, wrep = got["rep"], ref["rep"]
    assert grep.total_records == wrep.total_records > 0
    assert grep.total_instructions == wrep.total_instructions
    np.testing.assert_array_equal(grep.compression_ratios, wrep.compression_ratios)
    assert [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds, c.dropped,
             c.refs) for c in got["commits"]] == \
           [(c.ok, c.instructions, c.new_nodes, c.batch_nodes, c.probe_rounds, c.dropped,
             c.refs) for c in ref["commits"]]
    pipe = got["pipe"]
    assert pipe.store.node_keys.dtype == torch.int32
    _assert_arrays_equal(convert.store_to_numpy(pipe.store), ref["store"], "store")
    _assert_arrays_equal(convert.sketch_to_numpy(pipe.sink.sketch), ref["sketch"], "sketch")
    _assert_arrays_equal(convert.snapshot_to_numpy(pipe.sink.snapshot()), ref["snapshot"],
                         "snapshot")
    _assert_arrays_equal(convert.dictionary_to_numpy(got["dictionary"]), ref["dictionary"],
                         "dictionary")
    assert sum(c.dropped for c in ref["commits"]) > 0  # the small store saturates
    assert sum(c.refs for c in ref["commits"]) > 0  # the dictionary was used


def test_the_width_changes_what_the_loop_computes(runs):
    _, port = runs
    s32, s64 = port[torch.int32]["pipe"].store, port[torch.int64]["pipe"].store
    assert s64.node_keys.dtype == torch.int64
    assert port[torch.int32]["rep"].total_records == port[torch.int64]["rep"].total_records
    assert int(s32.n_nodes) < int(s64.n_nodes)
    d32 = sum(c.dropped for c in port[torch.int32]["commits"])
    d64 = sum(c.dropped for c in port[torch.int64]["commits"])
    assert d32 != d64


def test_convert_round_trips_a_32_bit_reference_state(runs):
    ref, _ = runs
    for what, to_port, to_numpy in (
            ("store", convert.store_from_numpy, convert.store_to_numpy),
            ("sketch", convert.sketch_from_numpy, convert.sketch_to_numpy),
            ("dictionary", convert.dictionary_from_numpy, convert.dictionary_to_numpy)):
        obj = to_port(ref[what], device="cpu")
        key = {"store": "node_keys", "sketch": "hh_keys", "dictionary": "sig"}[what]
        assert getattr(obj, key).dtype == torch.int32, what
        _assert_arrays_equal(to_numpy(obj), ref[what], what)


def test_a_32_bit_batch_survives_the_archive_spill(tmp_path):
    """A failed 32-bit commit spills to disk as uint32 keys and commits
    unchanged on retry."""
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 2**64 - 1, size=100, dtype=np.uint64)
    tables = []
    for _ in range(2):
        n = 120
        src, dst = ids[rng.integers(0, 100, n)], ids[rng.integers(0, 100, n)]
        et, z = rng.integers(0, 3, n).astype(np.int32), np.zeros(n, np.int32)
        tables.append(from_raw_batch(RawEdgeBatch(src, dst, et, z, z, n), 128, device="cpu",
                                     key_dtype=torch.int32))
    direct = PS.init_store(1 << 10, 1 << 11, device="cpu", key_dtype=torch.int32)
    for et in tables:
        direct, _ = PS.ingest_step(direct, et)
    down = [True]
    ing = GraphIngestor(PS.init_store(1 << 10, 1 << 11, device="cpu", key_dtype=torch.int32),
                        fail_hook=lambda: down[0], max_archive=1, archive_dir=str(tmp_path))
    for et in tables:
        assert not ing.push(et, now=0.0)["committed"]
    assert ing.archive_depth == 2 and len(list(tmp_path.iterdir())) == 1
    down[0] = False
    assert ing.retry_archive(now=1.0) == 2
    for f in dataclasses.fields(PS.GraphStore):
        assert torch.equal(getattr(ing.store, f.name), getattr(direct, f.name)), f.name


def test_a_dictionary_takes_the_width_of_its_edge_tables():
    d = PD.init_dictionary(64, device="cpu", key_dtype=torch.int32)
    assert d.sig.dtype == d.psig.dtype == torch.int32
    with pytest.raises(TypeError):
        PD.init_dictionary(64, device="cpu", key_dtype=torch.int16)


def test_a_sharded_pipeline_takes_the_builders_width(tmp_path):
    """Shards partition records by a string key and share the builder's
    transform and sink, so the width reaches every shard's commits."""
    b = (PipelineBuilder(IngestConfig(store_nodes=1 << 10, store_edges=1 << 11), device="cpu",
                         key_dtype=torch.int32)
         .with_source(BurstyTweetSource(seed=0)).with_compression().sharded(2)
         .spill_dir(str(tmp_path)))
    pipe = b.build()
    pipe.run(max_ticks=6)
    assert pipe.store.node_keys.dtype == pipe.store.edge_src.dtype == torch.int32
    assert b.dictionary_stage.dct.sig.dtype == torch.int32
    assert any(c.ok for c in pipe.sink.ingestor.commits)
    with pytest.raises(TypeError):
        PipelineBuilder(device="cpu", key_dtype=torch.float32)
