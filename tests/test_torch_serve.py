"""The port's serving loop (``repro_torch.launch.serve``, CPU) against the
same continuous-batching loop built from the JAX package's ``prefill`` and
``decode_step``, on the same weights and prompts: qwen1.5-0.5b ``SMOKE`` in
f32, so greedy tokens must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro import models as jax_models
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.launch import serve


def _jax_serve(params, cfg, prompts, batch, max_new):
    """``repro.launch.serve``'s loop, returning the generated tokens."""
    queue = list(prompts)
    prompt_len = len(queue[0])
    positions = jnp.broadcast_to(jnp.arange(prompt_len), (batch, prompt_len))
    max_len = prompt_len + max_new
    prefill = jax.jit(lambda p, t, pos: JT.prefill(p, cfg, t, pos, max_len=max_len))
    decode = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t))
    gens = []
    while queue:
        batch_prompts = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        while len(batch_prompts) < batch:
            batch_prompts.append(batch_prompts[-1])
        logits, state = prefill(params, jnp.asarray(np.stack(batch_prompts)), positions)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        outputs = [toks]
        for _ in range(max_new - 1):
            logits, state = decode(params, state, toks)
            toks = jnp.argmax(logits, -1).astype(jnp.int32)
            outputs.append(toks)
        gens.append(np.asarray(jnp.stack(outputs, axis=1)))
    return np.concatenate(gens)[: len(prompts)], np.asarray(logits)


@pytest.mark.parametrize("requests,batch", [(5, 2), (4, 4)])
def test_serve_loop_matches_the_reference(requests, batch):
    arch, max_new, prompt_len = "qwen1.5-0.5b", 6, 16
    jcfg = jax_configs.get_smoke_config(arch).replace(dtype=jnp.float32)
    tcfg = configs.get_smoke_config(arch).replace(dtype=torch.float32)
    params = jax_models.init_params(jax.random.key(0), jax_models.param_specs(jcfg))
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(requests)]
    want, want_logits = _jax_serve(params, jcfg, prompts, batch, max_new)
    got = serve.serve_requests(model, tcfg, prompts, batch, max_new)
    assert got.prefills == -(-requests // batch)
    assert bool(got.finite)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    np.testing.assert_allclose(got.last_logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)


def test_main_serves_on_the_cpu(capsys):
    out = serve.main(["--requests", "2", "--batch", "2", "--prompt-len", "16", "--max-new", "4",
                      "--device", "cpu"])
    assert out.tokens.shape == (2, 4) and out.prefills == 1
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < 512
    assert "[serve] 2 requests, 8 tokens" in capsys.readouterr().out


def test_main_needs_a_gpu_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1", "--batch", "1", "--prompt-len", "4", "--max-new", "2"])
