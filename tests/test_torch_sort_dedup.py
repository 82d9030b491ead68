"""Port parity: the bitonic sort-dedup kernel's plain version
(`repro_torch.kernels.edge_dedup`) and `ops.dedup_sorted_counts`.

The same numpy keys go through the reference's Pallas kernel
(`repro.kernels.edge_dedup.sort_dedup`, interpret mode on the CPU) and
the port's `ops.sort_dedup` on CPU tensors.  The port runs the same
network, so sorted, order and head must be equal bit for bit (tolerance
0), tie order included: tie-heavy key sets (every key equal, 5 values,
keys already sorted or reversed) are where a different sort would show.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.edge_dedup import sort_dedup as ref_sort_dedup
from repro_torch.kernels import build, edge_dedup, ops, ref

U32_MAX = 2**32 - 1


def _key_set(rng, n, kind):
    """n uint32 keys of one kind; the random kinds hold 0xFFFFFFFF."""
    if kind == "equal":
        return np.full(n, 123_456_789, np.uint32)
    if kind == "sorted":
        return np.sort(rng.integers(0, n, size=n)).astype(np.uint32)
    if kind == "reversed":
        return np.sort(rng.integers(0, n, size=n))[::-1].astype(np.uint32)
    values = {"5": 5, "n/4": max(n // 4, 1), "2^31": 2**31}[kind]
    keys = rng.integers(0, values, size=n).astype(np.uint32)
    keys[rng.integers(0, n, size=max(n // 16, 1))] = U32_MAX
    return keys


KINDS = ["5", "n/4", "2^31", "equal", "sorted", "reversed"]


@pytest.mark.parametrize("n", [64, 256, 1024, 4096])
def test_plain_version_matches_pallas_kernel_bit_for_bit(n):
    rng = np.random.default_rng(n)
    launches = dict(build.launches)
    for kind in KINDS:
        keys = _key_set(rng, n, kind)
        want = [np.asarray(a) for a in ref_sort_dedup(jnp.asarray(keys), interpret=True)]
        got = ops.sort_dedup(torch.from_numpy(keys.astype(np.int64)))
        assert [g.dtype for g in got] == [torch.int64, torch.int32, torch.int32]
        for name, g, w in zip(("sorted", "order", "head"), got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64), err_msg=f"{kind} {name}")
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel


def test_tie_order_is_the_network_s_not_a_stable_sort():
    keys = torch.from_numpy(_key_set(np.random.default_rng(3), 64, "5").astype(np.int64))
    sk, order, head = ops.sort_dedup(keys)
    stable_sk, stable_order, stable_head = ref.sort_dedup_ref(keys)
    assert torch.equal(sk, stable_sk) and torch.equal(head, stable_head)
    assert not torch.equal(order, stable_order)
    assert sorted(order.tolist()) == list(range(64))


@pytest.mark.parametrize("n", [1, 2, 512])
def test_stable_oracle_agrees_on_sorted_keys_and_heads(n):
    keys = torch.from_numpy(_key_set(np.random.default_rng(5), n, "5").astype(np.int64))
    sk, order, head = ops.sort_dedup(keys)
    rk, _, rhead = ref.sort_dedup_ref(keys)
    assert torch.equal(sk, rk) and torch.equal(head, rhead)
    assert torch.equal(keys[order.long()], sk)


@pytest.mark.parametrize("kind", ["5", "n/4", "equal"])
def test_dedup_sorted_counts_matches_reference(kind):
    keys = _key_set(np.random.default_rng(9), 512, kind)
    sk, head = (np.array(a) for a in ref_ops.sort_dedup(jnp.asarray(keys))[::2])
    want_counts, want_unique = (np.asarray(a) for a in
                                ref_ops.dedup_sorted_counts(jnp.asarray(sk), jnp.asarray(head)))
    counts, n_unique = ops.dedup_sorted_counts(torch.from_numpy(sk.astype(np.int64)),
                                               torch.from_numpy(head))
    assert counts.dtype == torch.int32 and n_unique.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert int(n_unique) == int(want_unique) == len(np.unique(keys))


def test_wrapper_checks_its_operand():
    with pytest.raises(ValueError, match="power of two"):
        ops.sort_dedup(torch.zeros(48, dtype=torch.int64))
    with pytest.raises(TypeError):
        ops.sort_dedup(torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sort_dedup(torch.zeros(128, dtype=torch.int64)[::2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_dedup.sort_dedup(torch.zeros(64, dtype=torch.int64, device="meta"))
