"""Autoregressive generation with a static KV cache, ported from
``singa_tpu/models/_generate.py`` (``prefill_step``, ``decode_step``,
``GenerateMixin.generate`` and ``_pick_impl``).

The reference runs the pick→decode loop as one jitted ``lax.scan``; here
it is a Python loop of eager steps.  Prefill runs the prompt forward
(the flash kernel on the card when the shape tiles) and writes the
caches; each decode step runs one token against the whole cache.

Sampling draws from a ``torch.Generator`` on the model's device seeded
by ``seed``.  Its streams are not the JAX package's (``jax.random``):
sampled tokens agree with the reference in distribution, not in value.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from ..model import model_device

__all__ = ["GenerateMixin", "prefill_step", "decode_step"]


@contextmanager
def _bound(model, params: Dict[str, torch.Tensor]):
    """Run the model with `params` (e.g. a bf16 copy of the f32 masters)
    in place of its own, in eval mode, then restore both."""
    ptens = model.get_params()
    saved = {n: t.data for n, t in ptens.items()}
    was_training = model.training
    model.eval()
    try:
        for n, t in ptens.items():
            t.data = params[n]
        yield
    finally:
        for n, t in ptens.items():
            t.data = saved[n]
        model.train(was_training)


def prefill_step(model, total_len: int, last_only: bool = True):
    """Build the prompt-forward closure: ids (B, P) -> (logits, caches)
    with fresh (B, total_len) caches written for positions [0, P).
    `last_only` returns just the last position's (B, V) logits."""

    def prefill(ids):
        logits, caches = model.forward_cached(
            ids, caches=model.init_caches(ids.shape[0], total_len), pos=0)
        return (logits[:, -1, :] if last_only else logits), caches

    return prefill


def decode_step(model):
    """Build the one-token decode closure: (tok (B, 1), pos, caches) ->
    (logits (B, V), caches).  `pos` is an int (all rows at one depth)
    or a (B,) tensor (every row at its own depth)."""

    def decode(tok, pos, caches):
        logits, caches = model.forward_cached(tok, caches=caches, pos=pos)
        return logits[:, 0, :], caches

    return decode


def _pick_impl(logits, temperature: float, generator: torch.Generator,
               top_k: Optional[int], top_p: Optional[float]):
    """Greedy (temperature 0) or sampled pick with optional top-k /
    nucleus (top-p) filtering."""
    if not temperature or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    if top_k is not None and 0 < top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (the
        # first token is always kept); the cutoff is the smallest kept
        # logit — everything below it is masked
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_lg,
                             torch.full_like(sorted_lg, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < cutoff, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class GenerateMixin:
    """Adds `generate()` to decoder models exposing
    `forward_cached(ids, caches, pos)` and `init_caches(batch, max_len)`."""

    def _gen_setup(self, prompt_ids, max_new_tokens: int, param_dtype=None):
        """Normalize the prompt, enforce max_position, and build the
        parameters for this call (cast once to `param_dtype` if given:
        decode is weight-read bound, so bf16 weights halve its bytes)."""
        ids = np.asarray(prompt_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, P = ids.shape
        S = P + max_new_tokens
        max_pos = getattr(getattr(self, "cfg", None), "max_position", None)
        if max_pos is not None and S > max_pos:
            # positions past max_position would index past the RoPE
            # tables — refuse loudly
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {S} "
                f"exceeds the model's max_position ({max_pos})")
        params = {n: t.detach() for n, t in self.get_params().items()}
        if param_dtype is not None:
            params = {n: (a.to(param_dtype) if a.is_floating_point() else a)
                      for n, a in params.items()}
        return ids, B, P, S, params

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 param_dtype: Optional[torch.dtype] = None) -> np.ndarray:
        """Greedy (temperature=0) or sampled decoding, with optional
        top-k and/or nucleus (top-p) filtering when sampling.

        prompt_ids: int array (B, P).  Always returns a (B, P +
        max_new_tokens) int32 numpy array.  When `eos_id` is given, rows
        keep decoding until every row has emitted it; the remaining
        positions are then filled with eos_id."""
        ids, B, P, S, params = self._gen_setup(prompt_ids, max_new_tokens,
                                               param_dtype)
        dev = model_device(self).torch_device
        temp = float(temperature) if temperature and temperature > 0 \
            else 0.0
        gen = torch.Generator(dev)
        gen.manual_seed(int(seed))
        toks = torch.empty((B, max_new_tokens), dtype=torch.int32,
                           device=dev)
        with _bound(self, params):
            logits, caches = prefill_step(self, S)(
                torch.as_tensor(ids, dtype=torch.int32, device=dev))
            logits = logits.float()
            decode = decode_step(self)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for i in range(max_new_tokens):
                tok = _pick_impl(logits, temp, gen, top_k, top_p)
                if eos_id is not None:
                    done |= tok == eos_id
                toks[:, i] = tok
                if eos_id is not None and bool(done.all()):
                    toks[:, i + 1:] = eos_id
                    break
                if i + 1 < max_new_tokens:
                    # the last pick needs no forward: its logits go unused
                    logits, caches = decode(toks[:, i:i + 1], P + i, caches)
                    logits = logits.float()
        return np.concatenate([ids.astype(np.int32),
                               toks.cpu().numpy()], axis=1)
