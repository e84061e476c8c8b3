"""Serving steps: batched prefill and single-token decode; the port of
``repro.train.serve_step``.  Eager torch without grad; the decode cache
is updated in place (``models.lm.decode_step``)."""
from __future__ import annotations

import torch

from ..models import lm as lm_mod
from ..models.config import ModelConfig
from ..runtime.mesh import batch_axes, constrain


def make_prefill_step(cfg: ModelConfig, last_only: bool = True):
    """Prefill: run the backbone over the prompt, emit last-token logits.

    ``last_only=True`` projects ONLY the final hidden state through the
    vocab head; ``False`` materializes (B, S, V) logits first.
    """
    @torch.no_grad()
    def prefill(params, batch):
        logits = lm_mod.forward(
            params, cfg,
            tokens=batch.get("tokens"),
            embeddings=batch.get("embeddings"),
            remat=False,
            last_only=last_only,
        )
        return logits[:, -1, :]

    return prefill


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, tokens, cache):
        logits, new_cache = lm_mod.decode_step(params, cfg, tokens, cache)
        # a DTensor's vocab gathered first: DTensor's argmax over a
        # dimension sharded on one mesh axis and replicated on another
        # views its partial results at a wrong shape
        next_tok = torch.argmax(constrain(logits, batch_axes(), None),
                                dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve_step


def greedy_generate(params, cfg: ModelConfig, prompt, max_new: int,
                    max_len: int):
    """Host loop generation on ``prompt``'s device: the prompt is
    prefilled token by token through the decode path (simple and exact),
    then ``max_new`` greedy tokens follow.  Returns (B, S + max_new)."""
    B, S = prompt.shape
    cache = lm_mod.init_cache(cfg, B, max_len, device=prompt.device)
    serve = make_serve_step(cfg)
    for i in range(S - 1):
        _, _, cache = serve(params, prompt[:, i: i + 1], cache)
    out = [prompt]
    tok = prompt[:, -1:]
    for _ in range(max_new):
        nxt, _, cache = serve(params, tok, cache)
        tok = nxt[:, None]
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
