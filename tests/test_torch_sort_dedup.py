"""Port parity: the bitonic sort-dedup kernel's plain version
(`repro_torch.kernels.edge_dedup`), its launch plan and
`ops.dedup_sorted_counts`.

The same numpy keys go through the reference's Pallas kernel
(`repro.kernels.edge_dedup.sort_dedup`, interpret mode on the CPU) and
the port's `ops.sort_dedup` on CPU tensors.  The port runs the same
network, so sorted, order and head must be equal bit for bit (tolerance
0), tie order included: tie-heavy key sets (every key equal, 5 values,
keys already sorted or reversed) are where a different sort would show.

The CUDA kernel runs only on the card, so its schedule is held here
through `_plan`: it must cover the network stage by stage in order, each
fused step must act on lane sets closed under its stages, and a torch
emulation that runs the plan step by step over those sets, on the
kernel's packed (key << 32 | position) words compared on the high word,
must give the plain version's outputs bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.edge_dedup import sort_dedup as ref_sort_dedup
from repro_torch.kernels import build, edge_dedup, ops, ref

U32_MAX = 2**32 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plan emulations run thousands of torch ops on tensors of up
    to 2^20 lanes.  On torch's intra-op threads such ops wait for every
    thread, and when the test run's workers share the cores they stall;
    one thread a worker keeps them at one core's speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --- the kernel's launch plan -------------------------------------------

E = edge_dedup


def _network(n):
    """The reference network's stages (k, j), in order."""
    out, k = [], 2
    while k <= n:
        j = k // 2
        while j >= 1:
            out.append((k, j))
            j //= 2
        k *= 2
    return out


def _step_stages(step):
    _, k, j, m = step
    return [(k, j >> q) for q in range(m)]


H100_CLUSTERS = 7  # clusters of 16 CTAs an H100 SXM runs at once, one CTA an SM


@pytest.mark.parametrize("clusters", [1, H100_CLUSTERS])
@pytest.mark.parametrize("log_n", range(23))
def test_plan_covers_the_network_once_in_network_order(log_n, clusters):
    n = 1 << log_n
    plan = E._plan(n, clusters)
    floors = E._floors(n, clusters)
    stages = [st for launch in plan for step in launch for st in _step_stages(step)]
    assert stages == _network(n)
    for launch in plan:
        for level, k, j, m in launch:
            assert all(E._level(jj, floors) == level for _, jj in _step_stages((level, k, j, m)))
            assert level == E.REG or m <= E.GROUP_STAGES
            assert level != E.GLOBAL or len(launch) == 1  # a device-memory step runs alone
    assert plan[-1] == () or plan[-1][0][0] != E.GLOBAL  # the last launch writes the outputs
    # one launch up to where device memory starts; above, per k a global
    # launch for each group of up to four stages from there, then a cluster launch
    clustered = n <= E.CLUSTER_LANES * clusters
    assert (E.CLUSTER in floors) == clustered
    first = (E.CLUSTER_LANES if clustered else E.CTA_LANES).bit_length() - 1
    extra = sum(-(-(log_k - first) // E.GROUP_STAGES) + 1 for log_k in range(first + 1, log_n + 1))
    assert len(plan) == 1 + extra
    assert E._encoded_plan(n, clusters)[1] == len(plan) + sum(len(launch) for launch in plan)


@pytest.mark.parametrize("n, clusters", [(1, 1), (16, 1), (32, 1), (512, 1), (1024, 1),
                                         (4096, 1), (8192, 1), (65536, 1), (1 << 17, 1),
                                         (1 << 17, H100_CLUSTERS), (1 << 20, H100_CLUSTERS)])
def test_plan_steps_act_on_lane_sets_closed_under_their_stages(n, clusters):
    for step in (step for launch in E._plan(n, clusters) for step in launch):
        lanes = E._step_lanes(step, n)
        assert torch.equal(lanes.flatten().sort().values, torch.arange(n))  # a partition
        if step[0] != E.REG:
            assert lanes.shape[1] == E.REG_LANES  # one thread's registers
        rows = lanes.sort(dim=1).values
        for _, j in _step_stages(step):
            assert torch.equal((lanes ^ j).sort(dim=1).values, rows), (step, j)


def _phase14_keys(rng, n, kind):
    """chip_smoke.py's `_dedup_keys`: n uint32 keys (as int64) of one kind."""
    if kind == "equal":
        return np.full(n, 123_456_789, np.int64)
    if kind in ("sorted", "reversed"):
        keys = np.sort(rng.integers(0, n, size=n))
        return keys if kind == "sorted" else keys[::-1].copy()
    keys = rng.integers(0, {"5": 5, "n/4": n // 4, "2^31": 2**31}[kind], size=n)
    keys[rng.integers(0, n, size=max(n // 16, 1))] = 2**32 - 1
    return keys


def _high(w):
    return (w >> 32) & 0xFFFFFFFF


def _phase_flip(lanes, k):
    """The XOR that takes each lane's stored key from phase k/2's form to
    phase k's (`phase_flip`): in phase k a lane with bit k set holds its
    key complemented, so that every pair ascends on the stored keys."""
    before = (lanes & (k // 2)) != 0 if k > 2 else torch.zeros_like(lanes, dtype=torch.bool)
    return torch.where(((lanes & k) != 0) != before, -(1 << 32), 0)  # the high word's bits


def _exchange_stage(w, d):
    """Register stage: column c meets c + d (bit d of c clear), the pair
    ascending on the stored keys, as `reg_stage` exchanges them."""
    s, size = w.shape
    w4 = w.view(s, size // (2 * d), 2, d)
    a, b = w4[:, :, 0], w4[:, :, 1]
    swap = _high(b) < _high(a)
    return torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], dim=2).view(s, size)


def _pick_stage(w, lanes, j, d):
    """Warp stage: the lower lane of each pair keeps the smaller stored
    key, the upper the larger, each taking its partner's position iff it
    took its partner's key, as `warp_stage` does."""
    p = w[:, torch.arange(w.shape[1]) ^ d]
    kw, kp = _high(w), _high(p)
    kept = torch.where((lanes & j) != 0, torch.maximum(kw, kp), torch.minimum(kw, kp))
    return torch.where(kept != kw, p, w)


def _emulate(keys, clusters):
    """The kernel's plan on the CPU: per step, gather each thread's (or
    warp's) lane set, flip the stored keys where the step starts a phase,
    run its stages there on the ascending stored keys, scatter back; heads
    as the last launch marks them, each segment's first lane against the
    largest key of the segment before it."""
    n = keys.shape[0]
    words = torch.from_numpy(((keys.astype(np.uint64) << np.uint64(32))
                              | np.arange(n, dtype=np.uint64)).view(np.int64))
    plan = E._plan(n, clusters)
    for i, launch in enumerate(plan):
        if i == len(plan) - 1:  # one cluster's lanes, or one CTA's where no step needs a cluster
            clustered = any(level == E.CLUSTER for level, _, _, _ in launch)
            segment = min(n, E.CLUSTER_LANES if clustered else E.CTA_LANES)
            prev_max = _high(words).view(-1, segment).max(dim=1).values
        for step in launch:
            level, k, j, m = step
            lanes = E._step_lanes(step, n)
            w = words[lanes]
            if j == k // 2:
                w = w ^ _phase_flip(lanes, k)
            for _, jj in _step_stages(step):
                d = int((lanes[0] == (lanes[0, 0] ^ jj)).nonzero())  # the partner's column
                if level == E.REG and jj >= E.REG_LANES:
                    w = _pick_stage(w, lanes, jj, d)
                else:
                    w = _exchange_stage(w, d)
            words[lanes.flatten()] = w.flatten()
    key = _high(words)
    head = edge_dedup.run_heads(key)
    starts = torch.arange(segment, n, segment)
    head[starts] = (key[starts] != prev_max[:-1]).to(torch.int32)
    return key, (words & 0xFFFFFFFF).to(torch.int32), head


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n, clusters", [(64, 1), (512, 1), (1024, 1), (4096, 1), (8192, 1),
                                         (16384, 1), (65536, 1), (1 << 17, 1),
                                         (1 << 17, H100_CLUSTERS)])
def test_plan_emulation_matches_plain_version_bit_for_bit(n, clusters, kind):
    keys = _phase14_keys(np.random.default_rng(n), n, kind)
    got = _emulate(keys, clusters)
    want = edge_dedup.sort_dedup_plain(torch.from_numpy(keys))
    for name, g, w in zip(("sorted", "order", "head"), got, want):
        assert torch.equal(g, w), f"{name} n={n} {kind}"
    if n <= 4096:
        with jax.enable_x64(True):
            ref = ref_sort_dedup(jnp.asarray(keys.astype(np.uint32)), interpret=True)
        for name, g, r in zip(("sorted", "order", "head"), got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64),
                                          err_msg=f"{name} n={n} {kind}")
