"""Port parity: the serving path (`repro_torch.data.tokenizer`,
`serving.kvcache`, `serving.decode.BatchServer` and `launch.serve`)
against the reference, on the CPU.

Token ids and cache sizes must be equal.  Served logits are held to the
reference's in float32 at atol = rtol = 1e-4, with the reference's
weights carried across by `convert.lm_params_from_numpy`; greedy ids
must then be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.distributed.sharding import init_params as jinit_params
from repro.models import model as JM
from repro.serving.decode import BatchServer as JServer
from repro.serving.kvcache import alloc_cache as jalloc_cache
from repro.serving.kvcache import cache_bytes as jcache_bytes
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch import serve
from repro_torch.serving.decode import BatchServer
from repro_torch.serving.kvcache import alloc_cache, cache_bytes, pad_cache_to

TOL = 1e-4
ARCHS = ["qwen2.5-3b", "mamba2-780m"]


def _f32(arch):
    return (dataclasses.replace(jsmoke_config(jget_config(arch)), dtype="float32"),
            dataclasses.replace(smoke_config(get_config(arch)), dtype="float32"))


def _weights(jcfg, cfg):
    params = jinit_params(JM.param_specs(jcfg), jax.random.key(0))
    return params, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")


@pytest.mark.parametrize("vocab", [256, 151_936])
def test_tokenizer_ids_equal_reference(vocab):
    texts = ["user3 says politics election vote #topic0", "", "a b a", "naïve café ✓"]
    ours, theirs = HashTokenizer(vocab), JTokenizer(vocab)
    for t in texts:
        assert ours.encode(t) == theirs.encode(t)
        assert ours.encode(t, add_special=False) == theirs.encode(t, add_special=False)
    got, want = ours.encode_batch(texts, 5), theirs.encode_batch(texts, 5)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_bytes_equal_reference(arch):
    jcfg, cfg = jsmoke_config(jget_config(arch)), smoke_config(get_config(arch))
    for batch, horizon in ((2, 64), (3, 4096)):
        assert cache_bytes(cfg, batch, horizon) == jcache_bytes(jcfg, batch, horizon)
        ours, theirs = alloc_cache(cfg, batch, horizon, "cpu"), jalloc_cache(jcfg, batch, horizon)
        assert sorted(ours) == sorted(theirs)
        for name in ours:
            assert tuple(ours[name].shape) == theirs[name].shape
            assert str(ours[name].dtype)[6:] == str(theirs[name].dtype)
            assert not ours[name].any()


def test_pad_cache_to_grows_kv_and_keeps_state():
    cfg = smoke_config(get_config("qwen2.5-3b"))
    cache = alloc_cache(cfg, 2, 16, "cpu")
    cache["k"].normal_()
    padded = pad_cache_to(cache, 32)
    assert padded["k"].shape[2] == 32 and torch.equal(padded["k"][:, :, :16], cache["k"])
    assert not padded["k"][:, :, 16:].any()
    ssm = alloc_cache(smoke_config(get_config("mamba2-780m")), 2, 16, "cpu")
    assert all(pad_cache_to(ssm, 64)[n] is ssm[n] for n in ssm)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_generates_the_reference_ids(arch):
    jcfg, cfg = _f32(arch)
    params, model = _weights(jcfg, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    srv = BatchServer(cfg, model)
    gen = srv.generate({"tokens": torch.from_numpy(toks)}, max_new=6)
    assert gen.shape == (2, 6) and gen.dtype == np.int32
    assert (gen >= 0).all() and (gen < cfg.padded_vocab).all() and srv.tokens_per_s > 0
    want = JServer(jcfg, params).generate({"tokens": jnp.asarray(toks)}, max_new=6)
    assert np.array_equal(gen, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_logits_match_reference_teacher_forced(arch):
    """`launch.serve`'s loop in float32: its prefill logits and each decode
    step's equal the reference's forward over the prompt and the port's
    generated tokens (teacher forcing), position by position."""
    jcfg, cfg = _f32(arch)
    params, model = _weights(jcfg, cfg)
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu", "--gen", "6"])
    _, _, tokens = serve.deployment(args)
    out = serve.serve(cfg, model, tokens, args.gen)
    assert out.gen.shape == (args.batch, args.gen) and out.prefill_ms > 0
    seq = np.concatenate([tokens.numpy(), out.gen[:, :-1]], axis=1)
    want, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(seq)})
    S = tokens.shape[1]
    for i, got in enumerate(out.logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[:, S - 1 + i]), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")
    assert np.array_equal(out.gen, np.asarray(jnp.argmax(want[:, S - 1:], axis=-1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_host(arch, capsys):
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16) and gen.dtype == np.int32
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 32 toks x 4 seqs: ")
    assert lines[1].startswith("decode  15 steps: ") and lines[2].startswith("generated ids[0][:8]:")
