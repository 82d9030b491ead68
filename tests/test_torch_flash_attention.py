"""Port parity: flash attention (K7), `repro_torch.kernels.flash_attention`.

The same numpy inputs go through the reference's Pallas kernel
(`repro.kernels.flash_attention.flash_attention`, interpret mode on the
CPU, as tests/test_kernels.py runs it), the reference's oracles, and the
port's `ops.flash_attention` on CPU tensors, which runs the kernel's
plain version (the online-softmax recurrence of `_sdpa_chunked`).
Tolerances are the reference test's: 2e-6 (atol and rtol) in float32,
2e-2 in bfloat16.  Grouped-query heads go through `_sdpa_chunked` in
both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro_torch.kernels import build, ops, ref
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
