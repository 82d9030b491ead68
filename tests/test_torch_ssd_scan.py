"""Port parity: the Mamba2 SSD chunked scan (K8),
`repro_torch.kernels.ssd_scan`, and the model's `ssd_chunked` over it.

The same numpy inputs (the reference test's recipe: x, B, C normal,
dt = softplus(normal), A = -|normal|) go through the reference's Pallas
kernel (`repro.kernels.ssd_scan.ssd_scan`, interpret mode on the CPU),
its sequential oracle `ssd_scan_ref`, its `mamba2.ssd_chunked`, and the
port's `ops.ssd_scan` and `ssd_chunked` on CPU tensors, which run the
kernel's plain version.  Tolerance: the reference test's 1e-4 (atol and
rtol) in float32, 1e-1 for a bfloat16 x.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import mamba2 as JM
from repro_torch.kernels import build, ops, ref
from repro_torch.models import mamba2 as TM

TOL = {"float32": 1e-4, "bfloat16": 1e-1}


def _inputs(seed, lead, S, p, N, heads_shape):
    """x lead+(S,)+heads+(p,), dt lead+(S,)+heads, A heads, B/C lead+(S, N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (S,) + heads_shape + (p,)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(lead + (S,) + heads_shape))).astype(np.float32)
    A = -np.abs(rng.standard_normal(heads_shape or lead)).astype(np.float32)
    B = rng.standard_normal(lead + (S, N)).astype(np.float32)
    C = rng.standard_normal(lead + (S, N)).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S,p,N,chunk", [(64, 16, 8, 16), (128, 32, 16, 32), (64, 16, 8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_pallas_kernel_and_recurrence(S, p, N, chunk, dtype):
    x, dt, A, B, C = _inputs(S + p, (2,), S, p, N, ())
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jx = jnp.asarray(x, jdt)
    jargs = [jnp.asarray(a) for a in (dt, A, B, C)]
    targs = [torch.from_numpy(a) for a in (dt, A, B, C)]
    launches = dict(build.launches)
    y, st = ops.ssd_scan(torch.from_numpy(x).to(tdt), *targs, chunk=chunk)
    assert y.dtype == tdt and st.dtype == torch.float32 and st.shape == (2, N, p)
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel
    py, pst = pallas_ssd(jx, *jargs, chunk=chunk, interpret=True)
    ry, rst = jref.ssd_scan_ref(jx, *jargs)
    tol = TOL[dtype]
    _close(y, py, tol)
    _close(st, pst, tol)
    _close(y, ry, tol)
    _close(st, rst, tol)
    oy, ost = ref.ssd_scan_ref(torch.from_numpy(x).to(tdt), *targs)
    _close(oy, ry, tol)
    _close(ost, rst, tol)


@pytest.mark.parametrize("S,chunk", [(40, 16), (48, 16), (33, 64)])
def test_ssd_chunked_matches_reference_with_padding(S, chunk):
    """S not a multiple of the chunk pads with dt = 0 steps outside the
    kernel, in both packages; heads share B and C (ngroups = 1)."""
    x, dt, A, B, C = _inputs(S, (2,), S, 8, 4, (3,))
    want_y, want_h = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)
    got_y, got_h = TM.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk)
    assert got_y.shape == (2, S, 3, 8) and got_h.shape == (2, 3, 4, 8)
    _close(got_y, want_y, TOL["float32"])
    _close(got_h, want_h, TOL["float32"])


def test_ssd_chunked_from_a_state_matches_reference():
    """The plain version carries an initial state (the kernel starts from
    zero and raises on one, on the card)."""
    x, dt, A, B, C = _inputs(5, (2,), 32, 8, 4, (3,))
    h0 = np.random.default_rng(6).standard_normal((2, 3, 4, 8)).astype(np.float32)
    want = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), 16,
                          init_state=jnp.asarray(h0))
    got = TM.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), 16,
                         init_state=torch.from_numpy(h0))
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


def test_decode_step_continues_the_scan():
    """One recurrent step after a chunked prefill equals the scan over the
    longer sequence, in the port as in the reference's definition."""
    x, dt, A, B, C = _inputs(8, (1,), 17, 8, 4, (2,))
    xt, dtt, At, Bt, Ct = (torch.from_numpy(a) for a in (x, dt, A, B, C))
    y_all, h_all = TM.ssd_chunked(xt, dtt, At, Bt, Ct, 16)
    _, h16 = TM.ssd_chunked(xt[:, :16], dtt[:, :16], At, Bt[:, :16], Ct[:, :16], 16)
    y1, h1 = TM.ssd_decode_step(xt[:, 16], dtt[:, 16], At, Bt[:, 16], Ct[:, 16], h16)
    _close(y1, y_all[:, 16].numpy(), TOL["float32"])
    _close(h1, h_all.numpy(), TOL["float32"])
    jy1, jh1 = JM.ssd_decode_step(*(jnp.asarray(a) for a in (
        x[:, 16], dt[:, 16], A, B[:, 16], C[:, 16])), jnp.asarray(h16.numpy()))
    _close(y1, jy1, TOL["float32"])
    _close(h1, jh1, TOL["float32"])
