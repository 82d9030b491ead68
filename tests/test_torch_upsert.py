"""Port parity: the fused upsert sweep.

`repro_torch.kernels.upsert` against the reference's Pallas kernel
(`repro.kernels.upsert.fused_upsert`, interpret mode) and its jnp
oracle, on 64-bit keys made with numpy.  The keys straddle bit 63 and
crowd onto a few probe slots, so hits, claims, contended claims (an
unsigned scatter-max between keys with and without bit 63) and drops
all occur.  Every output is compared bit for bit.

The CUDA kernel itself cannot run here; `chip_smoke.py` holds it
against `fused_upsert_ref` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import upsert as ref
from repro_torch.kernels import build
from repro_torch.kernels import upsert as port

CAP = 1024
LANES = 256


def _distinct_keys(rng, n):
    """n distinct uint64 keys in [1, 2^64 - 2], about half with bit 63 set."""
    keys = np.unique(rng.integers(1, 2**64 - 1, size=2 * n + 16, dtype=np.uint64))
    rng.shuffle(keys)
    return keys[:n]


def _first_slot(keys, cap):
    return port.probe_hash(torch.from_numpy(keys.view(np.int64)), cap, 0).numpy()


def _ref_upsert(fn, table, keys, valid, probes, **kw):
    with jax.enable_x64(True):
        tk, slot, new = fn(jnp.asarray(table), jnp.asarray(keys), jnp.asarray(valid),
                           jnp.int32(probes), **kw)
        return np.asarray(tk), np.asarray(slot), np.asarray(new)


def _port_upsert(fn, table, keys, valid, probes):
    tk, slot, new = fn(torch.from_numpy(table.view(np.int64).copy()),
                       torch.from_numpy(keys.view(np.int64).copy()),
                       torch.from_numpy(valid.copy()), probes)
    return tk.numpy().view(np.uint64), slot.numpy(), new.numpy()


def _case(seed, load, zero_key=False):
    """A table pre-filled to `load` and a batch of LANES unique keys:
    30% already present, the rest new, a quarter of those crowded onto
    eight first-probe slots, 10% of the lanes invalid."""
    rng = np.random.default_rng(seed)
    pool = _distinct_keys(rng, 64 * CAP)
    m = int(load * CAP)
    fill, rest = pool[:m], pool[m:]
    table = np.zeros(CAP, np.uint64)
    if m:
        table, fslot, _ = _ref_upsert(ref.fused_upsert_ref, table, fill,
                                      np.ones(m, bool), 1 << 12)
        assert (fslot >= 0).all()
    hot = np.flatnonzero(np.isin(_first_slot(rest, CAP), rng.choice(CAP, 8, replace=False)))
    n_present = int(0.3 * LANES) if m else 0
    n_hot = min(len(hot), LANES // 4)
    crowded = rest[hot[:n_hot]]
    fresh = np.setdiff1d(rest, crowded)[: LANES - n_present - n_hot]
    keys = np.concatenate([rng.choice(fill, n_present, replace=False) if m else fill[:0],
                           crowded, fresh])
    if zero_key:  # key 0 reads an empty slot as its own key
        keys[-1] = 0
    keys = keys[rng.permutation(LANES)]
    valid = rng.random(LANES) >= 0.1
    if zero_key:
        valid[keys == 0] = True
    return table, keys, valid


def test_probe_hash_matches_reference():
    rng = np.random.default_rng(1)
    keys = np.concatenate([_distinct_keys(rng, 4096),
                           np.array([0, 1, 2**63, 2**63 - 1, 2**64 - 1], np.uint64)])
    for cap in (1, 7, CAP, 1 << 20, 3 << 20):
        for i in (0, 1, 127, 2**31 - 1):
            with jax.enable_x64(True):
                want = np.asarray(ref.probe_hash(jnp.asarray(keys), cap,
                                                 jnp.full(keys.shape, i, jnp.int32)))
            got = port.probe_hash(torch.from_numpy(keys.view(np.int64)), cap, i).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"cap={cap} i={i}")


@pytest.mark.parametrize("probes", [32, 64, 128])
@pytest.mark.parametrize("load", [0.0, 0.5, 0.85])
def test_fused_upsert_ref_matches_pallas_and_oracle(load, probes):
    table, keys, valid = _case(int(load * 100) + probes, load)
    # both halves of the key space contend for the crowded slots
    first = _first_slot(keys[valid], CAP)
    hi = (keys[valid] >> np.uint64(63)).astype(bool)
    assert np.intersect1d(first[hi], first[~hi]).size > 0
    want = _ref_upsert(ref.fused_upsert, table, keys, valid, probes, interpret=True)
    oracle = _ref_upsert(ref.fused_upsert_ref, table, keys, valid, probes)
    got = _port_upsert(port.fused_upsert_ref, table, keys, valid, probes)
    for name, w, o, g in zip(("table", "slot", "is_new"), want, oracle, got):
        np.testing.assert_array_equal(o, w, err_msg=f"oracle {name}")
        np.testing.assert_array_equal(g, w, err_msg=f"port {name}")
    slot, new = got[1], got[2]
    assert new.any()  # claims
    if load > 0:
        assert (slot[valid & ~new] >= 0).any()  # hits
    if load == 0.85 and probes == 32:
        assert (slot[valid] < 0).any()  # drops under table pressure


def test_fused_upsert_zero_key_matches_pallas():
    table, keys, valid = _case(7, 0.5, zero_key=True)
    want = _ref_upsert(ref.fused_upsert, table, keys, valid, 64, interpret=True)
    got = _port_upsert(port.fused_upsert_ref, table, keys, valid, 64)
    for name, w, g in zip(("table", "slot", "is_new"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_wrapper_runs_plain_version_on_cpu_and_updates_in_place():
    table, keys, valid = _case(3, 0.5)
    before = build.launches["fused_upsert"]
    t = torch.from_numpy(table.view(np.int64).copy())
    out, slot, new = port.fused_upsert(t, torch.from_numpy(keys.view(np.int64)),
                                       torch.from_numpy(valid),
                                       torch.tensor(64, dtype=torch.int32))
    assert out is t  # in place
    want = _ref_upsert(ref.fused_upsert_ref, table, keys, valid, 64)
    np.testing.assert_array_equal(t.numpy().view(np.uint64), want[0])
    np.testing.assert_array_equal(slot.numpy(), want[1])
    np.testing.assert_array_equal(new.numpy(), want[2])
    assert slot.dtype == torch.int32 and new.dtype == torch.bool
    # the launch count moves only where the CUDA kernel launches
    assert build.launches["fused_upsert"] == before


@pytest.mark.parametrize("bad", ["int32_keys", "2d_table", "short_valid", "strided",
                                 "uint8_valid", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros(64, dtype=torch.int64)
    keys = torch.arange(1, 17, dtype=torch.int64)
    valid = torch.ones(16, dtype=torch.bool)
    if bad == "int32_keys":
        keys = keys.to(torch.int32)
    elif bad == "2d_table":
        table = table.reshape(8, 8)
    elif bad == "short_valid":
        valid = valid[:8]
    elif bad == "strided":
        keys = torch.arange(1, 33, dtype=torch.int64)[::2]
    elif bad == "uint8_valid":
        valid = valid.to(torch.uint8)
    else:
        table, keys, valid = table.to("meta"), keys.to("meta"), valid.to("meta")
    with pytest.raises((TypeError, ValueError)):
        port.fused_upsert(table, keys, valid, 32)
