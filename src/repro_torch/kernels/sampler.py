"""Counter-based traffic-id sampling for the workload generator.

Counterpart of `repro.kernels.sampler`.  Every lane derives its
randomness from a counter-based PRNG (lowbias32 finaliser over (seed,
lane counter)), so a block of n records is a pure function of (seed,
ctr0).  Per record the sampler draws NSTREAMS consecutive counters and
produces:
  * `uid`     Zipf(a_user) rank over n_users (bounded-Pareto inverse CDF),
  * `tag`     with probability `burst_frac` a hot-topic hashtag (one of
    `burst_ntags` ids from `topic_base`), else a Zipf(a_tag) rank,
  * `mention` with probability `copy_frac` the uid of a uniformly chosen
    earlier record of the block (a retweet cascade), else a
    Zipf(a_mention) rank,
  * `u_dup`/`u_dupi` two spare uniforms for the source's duplicates.

torch has no uint32 arithmetic, so the plain version holds uint32
values in int64 tensors and masks after every add and multiply, as
`query.sketch.node_hash` does.  It rounds every float32 operation on
its own and passes `pow` its exponents as tensors: torch's
`pow(tensor, scalar)` takes special paths for some exponents (-1, 0.5,
2) that round differently from `pow(tensor, tensor)`.

`traffic_ids` is the wrapper: with parameter tensors on a CUDA device
it launches the hand-written kernel `csrc/traffic_ids.cu` on the grid
the host's `launch_plan` gives (`Plan.ctas` x 3 CTAs, one for each of a
record's three Zipf ranks), on the CPU it runs the plain version
`traffic_ids_ref`.  `launch` runs the kernel under any plan it takes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

# one record consumes NSTREAMS consecutive counter lanes (6 used, 2
# reserved), so blocks advance the counter by n * NSTREAMS
NSTREAMS = 8
MAX_LANES = 1 << 20  # the block sizes the kernel takes (positions stay exact in float32)
_M32 = 0xFFFFFFFF

# The launch plan, from tools/k4_plan.py on an H100 (CTAs of 32 to
# MAX_THREADS threads, 1 to MAX_RECORDS records a thread, at 2,048 to
# 65,536 records, every scenario at bursts 0 and 1): CTAs of PLAN_THREADS
# threads, a record a thread, up to PLAN_CTAS CTAs a rank; past that
# CTAs of MAX_THREADS threads taking as many records a thread as keep
# PLAN_CTAS CTAs a rank (at most MAX_RECORDS).
PLAN_THREADS = 128
PLAN_CTAS = 128
MAX_THREADS = 256
MAX_RECORDS = 4


class Plan(NamedTuple):
    ctas: int  # CTAs a rank: the grid is ctas x 3
    threads: int  # a multiple of 32 up to MAX_THREADS
    records_a_thread: int  # 1 to MAX_RECORDS


def launch_plan(n: int) -> Plan:
    """The grid `traffic_ids` launches for n records: a record a thread
    on CTAs of PLAN_THREADS threads (cut to n rounded up to a warp) up to
    PLAN_CTAS CTAs a rank, then CTAs of MAX_THREADS threads with more
    records a thread.  CTA (c, r)'s thread t computes rank r of records
    c T R + k T + t, k < R."""
    if n <= PLAN_CTAS * PLAN_THREADS:
        threads, records = min(PLAN_THREADS, -(-n // 32) * 32), 1
    else:
        threads = MAX_THREADS
        records = min(MAX_RECORDS, -(-n // (MAX_THREADS * PLAN_CTAS)))
    return Plan(-(-n // (threads * records)), threads, records)


Traffic = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finaliser on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def counter_mix(seed: int, ctr: torch.Tensor) -> torch.Tensor:
    """Counter-based PRNG draw `fmix(fmix(ctr + k) ^ k)` with
    k = fmix(seed): uint32 values in int64 -> uint32 values in int64."""
    k = _fmix32(torch.tensor(int(seed) & _M32, dtype=torch.int64, device=ctr.device))
    x = _fmix32((ctr.to(torch.int64) + k) & _M32)
    return _fmix32(x ^ k)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniforms in [0, 1) (24-bit mantissa)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def zipf_rank(u: torch.Tensor, n: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Approximate Zipf(a) ranks in [0, n) through the bounded-Pareto
    inverse CDF on [1, n+1): (1 + u((n+1)^(1-a) - 1))^(1/(1-a)).

    `n` is an int32 and `a` a float32 0-d tensor on u's device."""
    nf = n.to(torch.float32)
    one_m_a = 1.0 - a
    top = torch.pow(nf + 1.0, one_m_a) - 1.0
    x = torch.pow(1.0 + u * top, (1.0 / one_m_a).expand_as(u))
    return torch.clamp(x.to(torch.int32) - 1, min=0).minimum(n - 1)


def _lanes(ctr0: int, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base counter (uint32 in int64) and block position of n records."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    lanes = (int(ctr0) + pos.to(torch.int64) * NSTREAMS) & _M32
    return lanes, pos


def traffic_ids_ref(seed: int, ctr0: int, n: int, iparams: torch.Tensor,
                    fparams: torch.Tensor) -> Traffic:
    """Plain PyTorch version, op for op the reference's `traffic_body`.

    iparams (4,) int32: n_users, n_tags, burst_ntags, topic_base;
    fparams (5,) float32: a_user, a_tag, a_mention, burst_frac, copy_frac.
    Returns (uid, tag, mention) int32 and (u_dup, u_dupi) float32."""
    lanes, pos = _lanes(ctr0, n, iparams.device)
    n_users, n_tags, burst_ntags, topic_base = iparams.unbind()
    a_user, a_tag, a_mention, burst_frac, copy_frac = fparams.unbind()

    def u(s):
        return uniform01(counter_mix(seed, (lanes + s) & _M32))

    u_uid, u_tag, u_mix = u(0), u(1), u(2)
    u_cas, u_src, u_men = u(3), u(4), u(5)
    uid = zipf_rank(u_uid, n_users, a_user)
    hot = (topic_base + (u_tag * burst_ntags.to(torch.float32)).to(torch.int32)) % n_tags
    tag = torch.where(u_mix < burst_frac, hot, zipf_rank(u_tag, n_tags, a_tag))
    # retweet cascade: copy the author of an earlier record in the block
    j = (u_src * pos.to(torch.float32)).to(torch.int64)
    use_copy = (u_cas < copy_frac) & (pos > 0)
    mention = torch.where(use_copy, uid[j], zipf_rank(u_men, n_users, a_mention))
    return uid, tag, mention, u(6), u(7)


def _check(seed, ctr0, n, iparams, fparams):
    if not (0 < n <= MAX_LANES):
        raise ValueError(f"block size must be in (0, {MAX_LANES}], got {n}")
    if not (0 <= int(seed) <= _M32 and 0 <= int(ctr0) <= _M32):
        raise ValueError("seed and ctr0 must be uint32 values")
    if iparams.shape != (4,) or iparams.dtype != torch.int32:
        raise TypeError("iparams must be a (4,) int32 tensor")
    if fparams.shape != (5,) or fparams.dtype != torch.float32:
        raise TypeError("fparams must be a (5,) float32 tensor")
    if iparams.device != fparams.device:
        raise ValueError(f"iparams and fparams must share a device, got "
                         f"{iparams.device} and {fparams.device}")


_ARGTYPES = ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def launch(seed, ctr0, n, iparams, fparams, plan: Plan) -> Traffic:
    """The kernel on CUDA tensors that `_check` passed, under `plan`.
    `traffic_ids` passes `launch_plan(n)`; tools/k4_plan.py and
    chip_smoke.py run every plan the kernel takes."""
    fn = build.library("traffic_ids").traffic_ids_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    dev = iparams.device
    ints = torch.empty((3, n), dtype=torch.int32, device=dev)
    floats = torch.empty((2, n), dtype=torch.float32, device=dev)
    ip, fp = iparams.contiguous(), fparams.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(int(seed), int(ctr0), n, ip.data_ptr(), fp.data_ptr(),
             ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
             floats[0].data_ptr(), floats[1].data_ptr(), plan.ctas, plan.threads,
             plan.records_a_thread, stream)
    if err != 0:
        raise RuntimeError(f"traffic_ids launch failed: cudaError {err} under {plan}")
    build.launches["traffic_ids"] += 1
    return ints[0], ints[1], ints[2], floats[0], floats[1]


def traffic_ids(seed: int, ctr0: int, n: int, iparams: torch.Tensor,
                fparams: torch.Tensor) -> Traffic:
    """One block of n records: (uid, tag, mention, u_dup, u_dupi).

    seed and ctr0 are uint32 values; iparams/fparams as in
    `traffic_ids_ref`, on the device that runs the block: a CUDA device
    launches the kernel, the CPU runs `traffic_ids_ref`."""
    _check(seed, ctr0, n, iparams, fparams)
    if iparams.device.type == "cuda":
        return launch(seed, ctr0, n, iparams, fparams, launch_plan(n))
    if iparams.device.type == "cpu":
        return traffic_ids_ref(seed, ctr0, n, iparams, fparams)
    raise ValueError(f"traffic_ids runs on cuda or cpu, not {iparams.device}")
