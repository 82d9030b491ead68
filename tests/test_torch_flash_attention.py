"""Port parity: flash attention (K7), `repro_torch.kernels.flash_attention`.

The same numpy inputs go through the reference's Pallas kernel
(`repro.kernels.flash_attention.flash_attention`, interpret mode on the
CPU, as tests/test_kernels.py runs it), the reference's oracles, and the
port's `ops.flash_attention` on CPU tensors, which runs the kernel's
plain version (the online-softmax recurrence of `_sdpa_chunked`).
Tolerances are the reference test's: 2e-6 (atol and rtol) in float32,
2e-2 in bfloat16.  Grouped-query heads go through `_sdpa_chunked` in
both packages.  The CUDA kernel's bf16 arithmetic (P split into two
bf16 parts before P·V) is emulated here and held to the reference at
the on-card check's tolerance, rtol 1e-2 with atol 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL

F32_TOL, BF16_TOL = 2e-6, 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S,d,block", [(128, 32, 32), (256, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_op_matches_pallas_kernel_and_oracle(S, d, block, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(S + d, [(3, S, d)] * 3, dtype)
    tol = DTYPES[dtype][2]
    launches = dict(build.launches)
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=block, block_k=block)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel
    _assert_close(got, pallas_flash(jq, jk, jv, causal=causal, block_q=block, block_k=block,
                                    interpret=True), tol)
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), tol)
    _assert_close(ref.flash_attention_ref(tq, tk, tv, causal=causal),
                  jref.flash_attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("window,block", [(64, 64), (48, 64)])
def test_sliding_window_matches_pallas_kernel(window, block):
    """A window of one block, and one narrower than a block: rows whose
    first keys are all masked carry weight-1 garbage until a real key
    wipes it, in the Pallas kernel and in the plain version alike."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(window, [(2, 256, 64)] * 3, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window, block_q=block,
                              block_k=block)
    _assert_close(got, pallas_flash(jq, jk, jv, causal=True, window=window, block_q=block,
                                    block_k=block, interpret=True), F32_TOL)
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=True, window=window),
                  F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_heads_match_reference_sdpa_chunked(causal, window, dtype):
    """q (B,S,n,h) against k/v (B,S,m,h): query head j reads kv head
    j // (n/m), as the reference's `_sdpa_chunked` flattens its heads."""
    B, S, n, m, h, chunk = 2, 128, 4, 2, 16, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, [(B, S, n, h), (B, S, m, h), (B, S, m, h)], dtype)
    got = TL._sdpa_chunked(tq, tk, tv, causal, window, chunk)
    assert got.shape == (B, S, n, h) and got.dtype == tq.dtype
    _assert_close(got, JL._sdpa_chunked(jq, jk, jv, causal, window, chunk), DTYPES[dtype][2])


def test_shapes_the_kernel_does_not_take_raise():
    q = torch.zeros(1, 96, 4, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TL._sdpa_chunked(q, q[:, :, :2], q[:, :, :2], True, None, 64)
    with pytest.raises(ValueError, match="group"):
        TL._sdpa_chunked(q, q[:, :, :3], q[:, :, :3], True, None, 32)
    with pytest.raises(TypeError):
        TL._sdpa_chunked(q.half(), q[:, :, :2].half(), q[:, :, :2].half(), True, None, 32)


KERNEL_TILE = 128  # the bf16 kernel's keys per K/V tile
CARD_RTOL, CARD_ATOL = 1e-2, 1e-4  # chip_smoke.py's bf16 check of the kernel


def _emulate_bf16_kernel(q, k, v, causal, window, split=True):
    """The bf16 CUDA kernel's arithmetic on the CPU: float32 scores from
    bf16 q and k in log2 units, masked to -1e30; an online softmax per
    tile of KERNEL_TILE keys with exp2; P rounded to bf16 before P·V, as
    a hi part plus the bf16 rounding of p - hi (one part if not `split`);
    l summed from the float32 p; the output rounded to bf16."""
    B, S, n, d = q.shape
    m = k.shape[2]
    qh = q.float().reshape(B, S, m, n // m, d)
    scale = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    acc = torch.zeros(B, m, n // m, S, d)
    mx = torch.full((B, m, n // m, S), -1e30)
    den = torch.zeros(B, m, n // m, S)
    for k0 in range(0, S, KERNEL_TILE):
        kb, vb = k[:, k0:k0 + KERNEL_TILE].float(), v[:, k0:k0 + KERNEL_TILE].float()
        s = torch.einsum("bqmgh,bkmh->bmgqk", qh, kb) * scale
        s = torch.where(fa._mask(S, k0, kb.shape[1], causal, window, "cpu"), s, -1e30)
        new_mx = torch.maximum(mx, s.amax(dim=-1))
        alpha = torch.exp2(mx - new_mx)
        p = torch.exp2(s - new_mx[..., None])
        den = den * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bmgqk,bkmh->bmgqh", hi, vb)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bmgqk,bkmh->bmgqh", lo, vb)
        acc = acc * alpha[..., None] + pv
        mx = new_mx
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, n, d).to(torch.bfloat16)


def _kernel_case(window):
    """Grouped heads (4 over 1), d 128, S 2,048: the bf16 inputs and the
    reference's `_sdpa_chunked` output on them."""
    B, S, n, m, d = 1, 2_048, 4, 1, 128
    (jq, jk, jv), (tq, tk, tv) = _inputs(11, [(B, S, n, d), (B, S, m, d), (B, S, m, d)],
                                         "bfloat16")
    with jax.enable_x64(True):
        want = np.asarray(JL._sdpa_chunked(jq, jk, jv, True, window, 512), np.float32)
    return (tq, tk, tv), want


@pytest.mark.parametrize("window", [None, 200])
def test_bf16_kernel_arithmetic_meets_the_card_check(window):
    """The kernel's bf16 design, emulated, is within the on-card check's
    rtol 1e-2 and atol 1e-4 of the reference: causal, and a 200-key
    window whose edge cuts the kernel's 128-key tiles."""
    (tq, tk, tv), want = _kernel_case(window)
    got = _emulate_bf16_kernel(tq, tk, tv, True, window)
    np.testing.assert_allclose(got.float().numpy(), want, atol=CARD_ATOL, rtol=CARD_RTOL)


def test_one_bf16_part_of_p_would_miss_the_card_check():
    """Why the kernel issues two P·V products: with P rounded once to
    bf16, outputs near 0 miss atol 1e-4 (the weights' rounding, 2^-9
    relative, times |v| near 1)."""
    (tq, tk, tv), want = _kernel_case(None)
    got = _emulate_bf16_kernel(tq, tk, tv, True, None, split=False).float().numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) > CARD_ATOL + CARD_RTOL * np.abs(want)).any()


@pytest.mark.parametrize("case", ["base", "head_stride", "position_stride"])
def test_bf16_inputs_that_tma_cannot_load_raise(case):
    """The bf16 kernel loads q, k and v by TMA: a base off 16 bytes or a
    stride of a dimension longer than 1 that is not whole 16-byte rows
    raises ValueError (the kernel never copies); extent-1 dimensions may
    have any stride."""
    ok = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    odd_unit_strides = torch.zeros(64 * 16, dtype=torch.bfloat16).as_strided((1, 64, 1, 16),
                                                                             (3, 16, 5, 1))
    fa._check_tma(ok, ok[:, :, :1], odd_unit_strides)
    bad = {"base": torch.zeros(2 * 64 * 2 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, 16),
           "head_stride": torch.zeros(2, 64, 2, 20, dtype=torch.bfloat16)[..., :16],
           "position_stride": torch.zeros(2, 64, 36, dtype=torch.bfloat16)[..., :32]
           .unflatten(2, (2, 16))}[case]
    with pytest.raises(ValueError, match="TMA"):
        fa._check_tma(ok, bad, ok)
