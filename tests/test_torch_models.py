"""The dense decoder of ``repro_torch`` (CPU) against the JAX package's
``repro.models``: layers, prefill, caches and decode, on the same weights.

Weights are the JAX package's seeded init with random biases and norm
scales added, carried over by ``repro_torch.convert.model_from_numpy``;
configs are each architecture's ``SMOKE`` in f32, so differences are f32
summation order only.  Tolerances: 1e-5 for single layers, 1e-4 for logits
and caches after the whole trunk (the reference's own prefill-vs-decode
test uses 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro import models as jax_models
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs, convert, models
from repro_torch.kernels import build
from repro_torch.models import layers as TL

ARCHS = ("qwen1.5-0.5b", "internlm2-1.8b")


def _cfgs(arch, **kw):
    """The same config in both packages, f32 compute."""
    jcfg = jax_configs.get_smoke_config(arch).replace(dtype=jnp.float32, **kw)
    tcfg = configs.get_smoke_config(arch).replace(dtype=torch.float32, **kw)
    return jcfg, tcfg


def _weights(jcfg, seed=0):
    """JAX's init as numpy, with random biases and norm scales."""
    params = jax_models.init_params(jax.random.key(seed), jax_models.param_specs(jcfg))
    tree = jax.tree.map(lambda a: np.array(a, dtype=np.float32), params)
    rng = np.random.default_rng(seed)
    layers = tree["layers"]
    for name in ("ln1", "ln2"):
        layers[name] = rng.uniform(0.5, 1.5, layers[name].shape).astype(np.float32)
    tree["final_norm"] = rng.uniform(0.5, 1.5, tree["final_norm"].shape).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            layers["attn"][name] = rng.normal(0, 0.5, layers["attn"][name].shape).astype(np.float32)
    return tree


def _jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference_field_for_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        jcfg = getattr(jax_configs, getter)(arch)
        tcfg = getattr(configs, getter)(arch)
        for field in type(jcfg).__dataclass_fields__:
            j, t = getattr(jcfg, field), getattr(tcfg, field)
            if field in ("dtype", "param_dtype"):
                assert str(t).removeprefix("torch.") == jnp.dtype(j).name, field
            else:
                assert j == t, (getter, field)
        assert tcfg.padded_vocab == jcfg.padded_vocab and tcfg.dh == jcfg.dh


def test_registry_names_the_ported_archs():
    with pytest.raises(KeyError, match="qwen1.5-0.5b"):
        configs.get_config("zamba2-7b")
    with pytest.raises(NotImplementedError, match="moe"):
        models.param_specs(configs.get_config("qwen1.5-0.5b").replace(family="moe"))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jspecs = jax.tree.leaves(jax_models.param_specs(jcfg),
                             is_leaf=lambda x: isinstance(x, jax_models.ParamSpec))
    tspecs = jax.tree.leaves(models.param_specs(tcfg),
                             is_leaf=lambda x: isinstance(x, models.ParamSpec))

    def key(s):
        return s.shape, s.axes, s.init

    assert [key(s) for s in jspecs] == [key(s) for s in tspecs]


def test_init_scales_follow_the_tags():
    cfg = configs.get_config("qwen1.5-0.5b").replace(num_layers=2, vocab_size=4096)
    model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wq, wo = model.layers[0].attn["wq"], model.layers[0].attn["wo"]
    # fan_in of a stacked (L, d, H, dh) leaf is L * d * H, as in the reference
    assert wq.std().item() == pytest.approx((2 * 1024 * 16) ** -0.5, rel=0.02)
    assert wo.std().item() == pytest.approx(0.5 * (2 * 16 * 64) ** -0.5, rel=0.02)
    assert model.embedding["tok"].std().item() == pytest.approx(0.02, rel=0.02)
    assert torch.all(model.layers[1].attn["bq"] == 0) and torch.all(model.final_norm == 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _weights(jcfg)
    p = _layer0(tree)
    rng = np.random.default_rng(1)
    B, S, d = 2, 12, jcfg.d_model
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + 3, (B, S))

    def close(got, want, tol=1e-5):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)

    close(TL.rmsnorm(_t(x), _t(p["ln1"]), tcfg.norm_eps), JL.rmsnorm(x, p["ln1"], jcfg.norm_eps))
    tp = {k: _t(v) for k, v in p["attn"].items()}
    q, k, v = TL.attention_qkv(tp, _t(x), tcfg)
    for got, want in zip((q, k, v), JL.attention_qkv(p["attn"], jnp.asarray(x), jcfg)):
        close(got, want)
    close(TL.apply_rope(q, _t(pos), tcfg.rope_theta),
          JL.apply_rope(jnp.asarray(q.numpy()), jnp.asarray(pos), jcfg.rope_theta))
    close(TL.attention_out(tp, q, tcfg), JL.attention_out(p["attn"], jnp.asarray(q.numpy()), jcfg))
    close(TL.mlp({k: _t(v) for k, v in p["mlp"].items()}, _t(x), tcfg),
          JL.mlp(p["mlp"], jnp.asarray(x), jcfg))
    emb = {k: _t(v) for k, v in tree["embedding"].items()}
    close(TL.logits_fn(emb, _t(x), tcfg), JL.logits_fn(tree["embedding"], jnp.asarray(x), jcfg))
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    close(TL.embed_tokens(emb, _t(toks), tcfg),
          JL.embed_tokens(tree["embedding"], jnp.asarray(toks), jcfg))
    cache_k = rng.normal(0, 1, (B, 20, jcfg.num_kv_heads, jcfg.dh)).astype(np.float32)
    cache_v = rng.normal(0, 1, cache_k.shape).astype(np.float32)
    q1 = q[:, :1]
    want = JL.decode_attention(jnp.asarray(q1.numpy()), cache_k, cache_v, 9)
    close(TL.decode_attention(q1, _t(cache_k), _t(cache_v), 9), want)


def test_padded_vocab_rows_never_win():
    cfg = configs.get_smoke_config("qwen1.5-0.5b").replace(vocab_size=500)
    assert cfg.padded_vocab == 512
    model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = model.prefill(torch.zeros((1, 4), dtype=torch.int32),
                              torch.arange(4).expand(1, 4))
    assert torch.all(logits[:, 500:] == -1e30) and int(logits.argmax(-1)) < 500


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _weights(jcfg)
    jparams = _jax_params(tree)
    model = convert.model_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    B, S, new = 2, 24, 4
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jl, jstate = JT.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), max_len=S + new)
    build.reset_launches()
    tl, tstate = model.prefill(torch.from_numpy(toks), torch.from_numpy(pos.copy()),
                               max_len=S + new)
    assert build.LAUNCHES["flash_attention"] == 0  # CPU: the plain attention
    assert tstate.pos == int(jstate.pos) == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        assert tstate.data[name].shape == jstate.data[name].shape
        np.testing.assert_allclose(tstate.data[name].numpy(), np.asarray(jstate.data[name]),
                                   rtol=1e-4, atol=1e-4)
    step = rng.integers(0, jcfg.vocab_size, (new, B)).astype(np.int32)
    for t in range(new):
        jl, jstate = JT.decode_step(jparams, jcfg, jstate, jnp.asarray(step[t]))
        tl, tstate = models.decode_step(model, tstate, torch.from_numpy(step[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert tstate.pos == int(jstate.pos) == S + new
    for name in ("k", "v"):
        np.testing.assert_allclose(tstate.data[name].numpy(), np.asarray(jstate.data[name]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_stepwise_decode(arch):
    """As ``tests/test_models.py``: logits after prefilling S tokens equal
    those of decoding them one at a time."""
    _, tcfg = _cfgs(arch, chunk_size=8)
    model = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    S = 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (1, S)))
    logits_p, _ = model.prefill(toks, torch.arange(S).expand(1, S))
    st = models.init_decode_state(tcfg, 1, S, "cpu")
    for t in range(S):
        logits_d, st = model.decode_step(st, toks[:, t])
    torch.testing.assert_close(logits_p[:, : tcfg.vocab_size], logits_d[:, : tcfg.vocab_size],
                               rtol=1e-4, atol=1e-4)


def test_decode_past_the_cache_raises():
    _, tcfg = _cfgs("qwen1.5-0.5b")
    model = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    st = models.init_decode_state(tcfg, 1, 1, "cpu")
    _, st = model.decode_step(st, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(st, torch.zeros(1, dtype=torch.int32))
