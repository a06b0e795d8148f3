"""Batched serving: continuous request batching over prefill/decode.

A minimal vLLM-style loop: requests arrive with prompts, get packed into a
fixed decode batch (the last batch padded with its last prompt), prefill
fills each slot's cache, and the decode step advances every slot one greedy
token per tick.  :func:`serve_requests` is the loop; :func:`main` is the
command line, which serves the architecture's smoke config with weights
drawn from a seeded generator.

Usage (on the GPU; ``--device cpu`` asks for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --batch 4 --prompt-len 32 --max-new 16
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_smoke_config
from ..core.stratify import resolve_device
from ..models import DenseTransformer, ModelConfig, init_params


class Served(NamedTuple):
    """``tokens`` (requests, max_new) int32, the generated tokens of every
    request; ``last_logits`` (batch, padded_vocab), the last decode step's;
    ``finite``, a 0-dim bool tensor: every logit of a real vocabulary row
    was finite; ``prefills``, the number of prefill calls."""

    tokens: torch.Tensor
    last_logits: torch.Tensor
    finite: torch.Tensor
    prefills: int


def serve_requests(model: DenseTransformer, cfg: ModelConfig, prompts, batch: int,
                   max_new: int) -> Served:
    """Serve ``prompts`` (equal-length int token arrays) in batches of
    ``batch``: prefill, then ``max_new - 1`` greedy decode steps.  Makes no
    host sync: the results stay on the model's device."""
    dev = model.final_norm.device
    queue = list(prompts)
    n_requests = len(queue)
    prompt_len = len(queue[0])
    positions = torch.arange(prompt_len, device=dev).expand(batch, prompt_len)
    max_len = prompt_len + max_new
    outputs, finite, logits, prefills = [], torch.ones((), dtype=torch.bool, device=dev), None, 0
    while queue:
        batch_prompts = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        while len(batch_prompts) < batch:  # pad the last batch
            batch_prompts.append(batch_prompts[-1])
        tokens = torch.as_tensor(np.stack(batch_prompts).astype(np.int32)).to(dev)
        logits, state = model.prefill(tokens, positions, max_len=max_len)
        prefills += 1
        finite = finite & torch.isfinite(logits[:, : cfg.vocab_size]).all()
        toks = torch.argmax(logits, -1).to(torch.int32)
        steps = [toks]
        for _ in range(max_new - 1):
            logits, state = model.decode_step(state, toks)
            finite = finite & torch.isfinite(logits[:, : cfg.vocab_size]).all()
            toks = torch.argmax(logits, -1).to(torch.int32)
            steps.append(toks)
        outputs.append(torch.stack(steps, dim=1))
    tokens = torch.cat(outputs)[:n_requests]
    return Served(tokens=tokens, last_logits=logits, finite=finite, prefills=prefills)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    served = serve_requests(model, cfg, prompts, args.batch, args.max_new)
    gen = served.tokens.cpu().numpy()
    dt = time.perf_counter() - t0
    for start in range(0, args.requests, args.batch):
        rows = gen[start : start + args.batch]
        print(f"[serve] batch done: generated {rows.shape} tokens; sample: {rows[0, :8]}")
    print(f"[serve] {args.requests} requests, {gen.size} tokens in {dt:.1f}s "
          f"({gen.size / max(dt, 1e-9):.1f} tok/s) on {dev}")
    return served


if __name__ == "__main__":
    main()
