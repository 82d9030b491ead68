"""Port parity: the LM stack's layers, the dense transformer and the
Mamba2 SSM (`repro_torch.models`) against the reference
(`repro.models`), on the CPU in float32.

The reference draws its weights (`init_params(param_specs(cfg), key)`),
and `convert.lm_params_from_numpy` carries them into the port's modules,
so both packages compute the same function.  Inputs are made from numpy
seeds.  Tolerances: logits at atol = rtol = 1e-4 (float32; the two
packages sum in other orders); the norm and RoPE, which sum little, at
1e-5; attention outputs and decode caches at rtol 1e-4 and atol 1e-4
times their largest magnitude (`_close_scaled`): the reference's init
(normal / sqrt(fan_in), fan_in = 4 heads for the output projection)
puts them near 80, where a float32 sum of 64 terms rounds at a few 1e-6
of that scale, and an entry that cancels to near 0 keeps that error.  The LM stack is 32-bit, so the
reference runs without x64, as its own tests/test_models.py runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.distributed.sharding import init_params as jinit_params
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.kvcache import pad_cache_to as jpad_cache_to
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.kvcache import pad_cache_to

TOL = 1e-4
LAYER_TOL = 1e-5
ARCHS = ["qwen2.5-3b", "mamba2-780m"]


def _cfgs(arch, **kw):
    """(reference config, port config): the smoke widths in float32."""
    return (dataclasses.replace(jsmoke_config(jget_config(arch)), dtype="float32", **kw),
            dataclasses.replace(smoke_config(get_config(arch)), dtype="float32", **kw))


def _weights(jcfg, cfg):
    params = jinit_params(JM.param_specs(jcfg), jax.random.key(0))
    return params, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _close_scaled(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _tokens(seed, cfg, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), LAYER_TOL)
    for xs, pos in ((x, np.arange(24)[None, :]), (x[:, :1], np.full((2, 1), 1_000))):
        _close(TL.apply_rope(torch.from_numpy(xs), torch.from_numpy(pos), 1_000_000.0),
               JL.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 1_000_000.0), LAYER_TOL)


@pytest.mark.parametrize("full_max,branch", [(8192, "full"), (64, "chunked")])
def test_attention_matches_reference_on_both_branches(full_max, branch):
    """S = 128: the materialised branch at the default attn_full_max, the
    chunked one (K7's plain version here) with attn_full_max = 64."""
    jcfg, cfg = _cfgs("qwen2.5-3b", attn_full_max=full_max)
    params, model = _weights(jcfg, cfg)
    x = np.random.default_rng(2).standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    launches = dict(build.launches)
    got = TL.attention(torch.from_numpy(x), model.layers[0].attn, cfg)
    assert dict(build.launches) == launches  # CPU tensors never launch the kernel
    _close_scaled(got, JL.attention(jnp.asarray(x), jp, jcfg))
    assert (128 > max(cfg.attn_full_max, 2 * cfg.attn_chunk)) == (branch == "chunked")


@pytest.mark.parametrize("window,pos", [(None, 20), (8, 5), (8, 20)])
def test_decode_attention_matches_reference(window, pos):
    """One-token attention against a cache: a full cache, and a sliding
    window's rolling buffer before (pos < W) and after it wraps."""
    jcfg, cfg = _cfgs("qwen2.5-3b", sliding_window=window)
    params, model = _weights(jcfg, cfg)
    rng = np.random.default_rng(pos)
    W = 24 if window is None else window
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, W, cfg.num_kv_heads, cfg.resolved_head_dim))
              .astype(np.float32) for _ in range(2))
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    want = JL.decode_attention(jnp.asarray(x), jp, jcfg, jnp.asarray(ck), jnp.asarray(cv),
                               jnp.int32(pos))
    got = TL.decode_attention(torch.from_numpy(x), model.layers[0].attn, cfg,
                              torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), pos)
    for g, w in zip(got, want):
        _close_scaled(g, w)


def test_pack_swa_cache_matches_reference():
    k = np.random.default_rng(3).standard_normal((2, 20, 2, 4)).astype(np.float32)
    _close(TT._pack_swa_cache(torch.from_numpy(k), 20, 8),
           JT._pack_swa_cache(jnp.asarray(k), 20, 8), 0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    params, model = _weights(jcfg, cfg)
    toks = _tokens(4, cfg, 2, 33)
    got, _ = TM.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    want, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    assert got.shape == (2, 33, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("arch,full_max,S", [("qwen2.5-3b", 8192, 32), ("qwen2.5-3b", 64, 128),
                                             ("mamba2-780m", 8192, 33)])
def test_prefill_and_decode_match_reference(arch, full_max, S):
    """Prefill logits and cache, then three decode steps fed the
    reference's own greedy tokens, the reference's cache handed to the
    port.  The dense prompt of 128 tokens with attn_full_max = 64 takes
    the chunked branch; the SSM prompt of 33 pads to its chunk of 16."""
    jcfg, cfg = _cfgs(arch, attn_full_max=full_max)
    params, model = _weights(jcfg, cfg)
    toks = _tokens(S, cfg, 2, S)
    want, jcache = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, cache = TM.prefill(model, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    for name in jcache:
        _close_scaled(cache[name], jcache[name])
    total = S + 3
    jcache = jpad_cache_to(jcache, total) if cfg.family == "dense" else jcache
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    cache = pad_cache_to(cache, total)
    tok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    for i in range(3):
        want, jcache = JM.decode_step(params, jcfg, jcache, tok, jnp.int32(S + i))
        got, cache = TM.decode_step(model, cfg, cache, torch.from_numpy(np.array(tok)), S + i)
        _close(got, want)
        tok = jnp.argmax(want, axis=-1).astype(jnp.int32)


def test_other_families_wait_for_a_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        get_config("mixtral-8x7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    moe = dataclasses.replace(smoke_config(get_config("qwen2.5-3b")), family="moe")
    with pytest.raises(NotImplementedError, match="later slice"):
        TM.init_params(moe, "cpu")


def test_init_matches_reference_shapes_and_kinds():
    """The port's own init: every parameter of the reference's tree, its
    shape and dtype, the ones/zeros kinds exactly, A_log in log[1, 16]
    and the normal kinds at their scale."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        specs = jax.tree.map(np.asarray, jinit_params(JM.param_specs(jcfg), jax.random.key(0)))
        model = TM.init_params(cfg, "cpu", seed=3, dtype="bfloat16")
        params = dict(model.named_parameters())
        names = {n for n, _ in convert._flatten(specs)}
        for name in names:
            leaf = specs
            for part in name.split("."):
                leaf = leaf[part]
            key = name.replace("layers.", "layers.0.")
            assert tuple(params[key].shape) == leaf.shape[1 if "layers." in name else 0:], name
            assert params[key].dtype == torch.bfloat16
        if arch == "mamba2-780m":
            a_log = model.layers[0].mamba.A_log.float()
            assert bool(((a_log >= 0) & (a_log <= np.log(16.0) + 1e-2)).all())
            assert bool((model.layers[1].mamba.D == 1).all())
        emb = model.embed.float()
        assert abs(float(emb.std()) - 0.02) < 0.002
