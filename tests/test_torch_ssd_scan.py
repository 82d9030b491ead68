"""Port parity: the Mamba2 SSD chunked scan (K8),
`repro_torch.kernels.ssd_scan`, and the model's `ssd_chunked` over it.

The same numpy inputs (the reference test's recipe: x, B, C normal,
dt = softplus(normal), A = -|normal|) go through the reference's Pallas
kernel (`repro.kernels.ssd_scan.ssd_scan`, interpret mode on the CPU),
its sequential oracle `ssd_scan_ref`, its `mamba2.ssd_chunked`, and the
port's `ops.ssd_scan` and `ssd_chunked` on CPU tensors, which run the
kernel's plain version.  Tolerance: the reference test's 1e-4 (atol and
rtol) in float32, 1e-1 for a bfloat16 x.

At the serving path's chunk (Q = 256, N = 128, p = 64) the port and an
emulation of the CUDA kernel's three passes are held at 1e-4 to the
reference's sequential definition `ssd_scan_ref`.  The reference's
Pallas kernel and its `ssd_chunked` form the prefix sums of dt*A in
float32 and miss that definition there by up to 2.9 times 1e-4; the
port sums them in float64, so it is held to the definition, and the
Pallas kernel to the port where its float32 sums do not reach (the
final state).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import mamba2 as JM
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2 as TM

TOL = {"float32": 1e-4, "bfloat16": 1e-1}
PATH_CHUNK = (1, 512, 2, 64, 128, 256)  # B, S, nh, p, N, Q: two heads sharing B and C


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


def _per_head(x, dt, A, B, C):
    """The Mamba2 layout as the reference kernel's (BH, S, *) arrays, B
    and C repeated for each head."""
    Bz, S, nh, p = x.shape
    return (jnp.asarray(x.transpose(0, 2, 1, 3).reshape(Bz * nh, S, p)),
            jnp.asarray(dt.transpose(0, 2, 1).reshape(Bz * nh, S)),
            jnp.asarray(np.tile(A, Bz)), jnp.asarray(np.repeat(B, nh, axis=0)),
            jnp.asarray(np.repeat(C, nh, axis=0)))


def _from_heads(y, state, Bz, nh):
    """The reference kernel's y (BH, S, p) and state (BH, N, p) as the
    port's (B, S, nh, p) and (B, nh, N, p)."""
    y, state = np.asarray(y, np.float32), np.asarray(state, np.float32)
    return (y.reshape(Bz, nh, *y.shape[1:]).transpose(0, 2, 1, 3),
            state.reshape(Bz, nh, *state.shape[1:]))


def _kernel_emulation(x, dt, A, Bs, Cs, Q, tile=64, step=32):
    """The CUDA kernel's arithmetic in torch, pass by pass, in float32:
    1. seg: float32 products dt*A summed in float64; the chunk's own
       state S_c = B^T (w o x), w = exp(f32(total - seg)) dt;
    2. h_c = exp(f32(total_c)) h_{c-1} + S_c, keeping the state before
       each chunk;
    3. per 64-row query tile, G = C B^T over the tile's keys once for
       every head, then per head C h_prev over 32 state rows at a time,
       scaled by exp(f32(seg_i)), plus ((G o L) x) over 32 keys at a
       time, L from float64 differences, masked before exp."""
    Bz, S, nh, p = x.shape
    N = Bs.shape[-1]
    nc = S // Q
    f32 = torch.float32
    xc = x.reshape(Bz, nc, Q, nh, p)
    dtc = dt.reshape(Bz, nc, Q, nh)
    Bc, Cc = Bs.reshape(Bz, nc, Q, N), Cs.reshape(Bz, nc, Q, N)
    seg = torch.cumsum((dtc * A).double(), dim=2)  # (B, nc, Q, nh)
    total = seg[:, :, -1]
    w = torch.exp((total[:, :, None] - seg).to(f32)) * dtc
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bc, w[..., None] * xc)
    h = torch.zeros_like(S_c[:, 0])
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c].to(f32))[:, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, nh, N, p)
    y = torch.empty_like(xc)
    for i0 in range(0, Q, tile):
        kend = min(Q, i0 + tile)
        rows = slice(i0, kend)
        G = torch.einsum("bcin,bcjn->bcij", Cc[:, :, rows], Bc[:, :, :kend])  # once for all heads
        acc = torch.zeros_like(xc[:, :, rows])
        for n0 in range(0, N, step):
            n = slice(n0, min(N, n0 + step))
            acc = acc + torch.einsum("bcin,bchnp->bcihp", Cc[:, :, rows, n], h_prev[:, :, :, n])
        acc = acc * torch.exp(seg[:, :, rows].to(f32))[..., None]
        for j0 in range(0, kend, step):
            keys = slice(j0, min(kend, j0 + step))
            causal = (torch.arange(i0, kend)[:, None]
                      >= torch.arange(keys.start, keys.stop))[None, None, :, :, None]
            diff = (seg[:, :, rows, None] - seg[:, :, None, keys]).to(f32)  # (B,nc,i,j,nh)
            L = torch.where(causal, torch.exp(torch.where(causal, diff, torch.zeros_like(diff)))
                            * dtc[:, :, None, keys], torch.zeros_like(diff))
            acc = acc + torch.einsum("bcijh,bcjhp->bcihp", G[:, :, :, keys, None] * L,
                                     xc[:, :, keys])
        y[:, :, rows] = acc
    return y.reshape(Bz, S, nh, p), h


@pytest.mark.parametrize("impl", ["port", "kernel_emulation"])
def test_scan_at_the_paths_chunk_matches_reference_recurrence(impl):
    """Q = 256, N = 128, p = 64 over two chunks, two heads sharing B and
    C: the port's `scan` on CPU tensors (the plain version) and the
    emulation of the CUDA kernel's passes, each within 1e-4 of the
    reference's sequential definition."""
    Bz, S, nh, p, N, Q = PATH_CHUNK
    arrays = _inputs(18, (Bz,), S, p, N, (nh,))
    ry, rst = _from_heads(*jref.ssd_scan_ref(*_per_head(*arrays)), Bz, nh)
    targs = [torch.from_numpy(a) for a in arrays]
    y, st = (ss.scan(*targs, Q) if impl == "port" else _kernel_emulation(*targs, Q))
    assert y.shape == (Bz, S, nh, p) and st.shape == (Bz, nh, N, p)
    _close(y, ry, TOL["float32"])
    _close(st, rst, TOL["float32"])


def test_pallas_kernel_at_the_paths_chunk_against_the_port():
    """The reference's Pallas K8 (interpret mode) at the path's chunk:
    its final state is within 1e-4 of the port's; its y, from float32
    prefix sums, lies farther from the sequential definition than the
    port's y does (relative to the 1e-4 check)."""
    Bz, S, nh, p, N, Q = PATH_CHUNK
    arrays = _inputs(18, (Bz,), S, p, N, (nh,))
    jargs = _per_head(*arrays)
    py, pst = _from_heads(*pallas_ssd(*jargs, chunk=Q, interpret=True), Bz, nh)
    ry, _ = _from_heads(*jref.ssd_scan_ref(*jargs), Bz, nh)
    y, st = ss.scan(*(torch.from_numpy(a) for a in arrays), Q)
    _close(st, pst, TOL["float32"])
    want = ry.astype(np.float64)

    def worst(got):  # largest error over the check's allowance, 1e-4 + 1e-4 |want|
        tol = TOL["float32"]
        return float((np.abs(np.asarray(got, np.float64) - want) / (tol + tol * np.abs(want))).max())

    assert worst(y.numpy()) < worst(py)


@pytest.mark.parametrize("p,N,chunk", [(129, 128, 256), (64, 129, 256), (64, 128, 512)])
def test_kernel_refuses_shapes_it_does_not_take(p, N, chunk):
    """Head width over 128, state over 128 or chunk over 256 raise before
    any launch; the path's widest shapes pass."""
    ss.check_kernel_shape(128, 128, 256)
    with pytest.raises(ValueError):
        ss.check_kernel_shape(p, N, chunk)
