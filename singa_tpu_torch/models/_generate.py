"""Autoregressive generation with a static KV cache, ported from
``singa_tpu/models/_generate.py`` (``prefill_step``, ``decode_step``,
``_GenSession``, ``GenerateMixin.generate`` and ``_pick_impl``).

The reference runs generation as two jitted programs: the prefill, and
one ``lax.scan`` over every pick→decode step.  Here a `_GenSession`
(one per batch, prompt length, total length, parameter dtype and pick
options, kept on the model) captures two CUDA graphs on the card: the
prefill with the first pick (the flash forward on the prompt), and one
decode→pick step, replayed max_new_tokens - 1 times.  One step graph
replayed is captured in a fraction of the time N steps would take,
serves every call of the session, and costs one graph launch of host
time per token.  The decode position, the eos state and the generator
are on the device, so each replay reads its own.  The pick options are
host constants of the graphs, hence part of the session's key.  On the
CPU a session runs the same steps eagerly.

The weights are cast inside the prefill graph into one static copy per
parameter dtype, which all the model's sessions share, so every call
sees the current masters.  A session holds its caches and its graphs'
pools: a model keeps at most `MAX_SESSIONS` of them and drops the least
recently used.

``use_graph=False`` runs `_generate_eager`, which keeps no state: the
parameters are cast for the call, the position is a host int and the
loop stops once every row has emitted eos.  Its tokens equal a
session's.

Sampling draws from the session's ``torch.Generator``, seeded by
``seed``, registered with the graphs so every replay draws afresh.  Its
streams are not the JAX package's (``jax.random``): sampled tokens agree
with the reference in distribution, not in value.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from .. import autograd
from ..graph import CapturedGraph, record
from ..graph import epoch as graph_epoch
from ..model import model_device

__all__ = ["GenerateMixin", "prefill_step", "decode_step"]

#: the most generate() sessions a model keeps (least recently used first
#: out): each holds (B, S) caches for every layer and its graphs' pools
MAX_SESSIONS = 4


@contextmanager
def _bound(model, params: Dict[str, torch.Tensor]):
    """Run the model with `params` (e.g. a bf16 copy of the f32 masters)
    in place of its own, in eval mode, then restore both."""
    ptens = model.get_params()
    saved = {n: t.data for n, t in ptens.items()}
    was_training, flag = model.training, autograd.is_training()
    model.eval()
    try:
        for n, t in ptens.items():
            t.data = params[n]
        yield
    finally:
        for n, t in ptens.items():
            t.data = saved[n]
        model.train(was_training)
        autograd.set_training(flag)


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
    (logits (B, V), caches).  `pos` is an int (all rows at one depth),
    a 0-d tensor (the same, on the device) or a (B,) tensor (every row
    at its own depth)."""

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
    # one draw of torch.multinomial(probs, 1) written out: argmax of
    # probs / Exp(1) noise.  multinomial itself checks its input on the
    # host, which a captured step cannot do
    probs = torch.softmax(lg, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def _static_params(model, dtype) -> Dict[str, torch.Tensor]:
    """The parameters the sessions read, in `dtype`: one static copy per
    dtype, shared by all the model's sessions and refreshed from the
    masters by each session's prefill; the masters themselves when
    `dtype` is None.  Made anew when the masters are no longer the
    tensors it was made for."""
    masters = {n: t.detach() for n, t in model.get_params().items()}
    if dtype is None:
        return masters
    addrs = tuple((n, t.data_ptr()) for n, t in masters.items())
    held = model._gen_params.get(dtype)
    if held is None or held[0] != addrs:
        held = model._gen_params[dtype] = (addrs, {
            n: (torch.empty_like(t, dtype=dtype) if t.is_floating_point()
                else t) for n, t in masters.items()})
    return held[1]


class _GenSession:
    """generate() for one (batch, prompt length, total length, parameter
    dtype, pick options): on a CUDA device a captured prefill and a
    captured decode step; on the CPU the same steps run eagerly.

    Static state: the shared parameters in the dtype asked for (see
    `_static_params`), the prompt, the current token, its position, the
    eos flags and the (B, N) tokens.  A call runs the prefill (masters
    cast into the static parameters, prompt forward, first pick) and
    N - 1 decode steps (one token forward at the device position, next
    pick).  The first call runs the steps eagerly (on a card, on the
    capture's side stream: the warm-up) and records each step's first
    run; on a card the second call captures them and every later one
    replays them."""

    def __init__(self, model, batch: int, prompt_len: int, total_len: int,
                 param_dtype, opts):
        self.model, self.opts = model, opts
        self.prompt_len, self.total_len = prompt_len, total_len
        dev = self.device = model_device(model).torch_device
        self.epoch = graph_epoch()
        self.masters = {n: t.detach() for n, t in model.get_params().items()}
        self.params = _static_params(model, param_dtype)
        n_new = total_len - prompt_len
        self.ids = torch.zeros((batch, prompt_len), dtype=torch.int32,
                               device=dev)
        self.toks = torch.zeros((batch, n_new), dtype=torch.int32,
                                device=dev)
        self.tok = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.gen = torch.Generator(dev)
        self.caches = None
        self.calls = 0
        self.graphs: Dict[str, CapturedGraph] = {}
        self._stream = None

    def fits(self, model) -> bool:
        """Whether the session is of the current graph epoch and the
        model's masters are still the ones it reads (a graph reads them
        by address)."""
        params = model.get_params()
        return self.epoch == graph_epoch() \
            and params.keys() == self.masters.keys() and all(
                params[n].data_ptr() == t.data_ptr()
                for n, t in self.masters.items())

    # -- the two steps --------------------------------------------------------
    def _pick(self, logits) -> None:
        """Pick the next token of every row from (B, V) f32 logits and
        write it at column pos - P of the tokens."""
        temp, top_k, top_p, eos_id = self.opts
        tok = _pick_impl(logits, temp, self.gen, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(self.stopped, eos_id, tok)
            self.done |= tok == eos_id
            self.stopped.copy_(self.done.all())
        self.tok.copy_(tok)
        col = (self.pos - self.prompt_len).reshape(1)
        self.toks.index_copy_(1, col, tok[:, None].to(torch.int32))

    def _prefill(self) -> None:
        for n, t in self.params.items():
            if t is not self.masters[n]:
                t.copy_(self.masters[n])
        with _bound(self.model, self.params):
            logits, self.caches = prefill_step(self.model, self.total_len)(
                self.ids)
        self.pos.fill_(self.prompt_len)
        self.done.zero_()
        self.stopped.zero_()
        self._pick(logits.float())

    def _decode(self) -> None:
        with _bound(self.model, self.params):
            logits, _ = decode_step(self.model)(self.tok[:, None], self.pos,
                                                self.caches)
        self.pos += 1
        self._pick(logits.float())

    # -- a call ---------------------------------------------------------------
    def run(self, ids: np.ndarray, n_new: int, seed: int) -> np.ndarray:
        """(B, n_new) int32 tokens for prompt `ids`."""
        self.ids.copy_(torch.as_tensor(ids, dtype=torch.int32))
        self.gen.manual_seed(int(seed))
        if self.calls == 0:
            self._warm_up(n_new)
        elif self.device.type != "cuda":
            self._prefill()
            for _ in range(n_new - 1):
                self._decode()
        else:
            if self.calls == 1:
                self._capture()
            self.graphs["prefill"].replay()
            for _ in range(n_new - 1):
                self.graphs["decode"].replay()
        self.calls += 1
        return self.toks.cpu().numpy()

    def _warm_up(self, n_new: int) -> None:
        """The first call: eager (on a card, on the capture's side
        stream), with the first run of each step recorded."""
        ctx = nullcontext()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            _, self.graphs["prefill"] = record("prefill", self._prefill)
            for i in range(n_new - 1):
                if i == 0:
                    _, self.graphs["decode"] = record("decode", self._decode)
                else:
                    self._decode()
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _capture(self) -> None:
        """Capture the prefill, then the decode step over the caches the
        prefill graph writes."""
        gens = (self.gen,) if self.opts[0] > 0 else ()
        if gens and not hasattr(torch.cuda.CUDAGraph,
                                "register_generator_state"):
            raise RuntimeError(
                f"sampled generate() cannot be captured with torch "
                f"{torch.__version__}: its CUDAGraph has no "
                f"register_generator_state; pass use_graph=False")
        self.graphs["prefill"].capture(self._prefill, self._stream, gens)
        if "decode" in self.graphs:
            self.graphs["decode"].capture(self._decode, self._stream, gens)


def _generate_eager(model, ids: np.ndarray, total_len: int, n_new: int,
                    seed: int, opts, param_dtype) -> np.ndarray:
    """(B, n_new) int32 tokens, each step launched from the host, with
    no state kept: the parameters cast for this call, the position a
    host int, and no forward once every row has emitted eos."""
    temp, top_k, top_p, eos_id = opts
    dev = model_device(model).torch_device
    params = {n: t.detach() for n, t in model.get_params().items()}
    if param_dtype is not None:
        params = {n: (t.to(param_dtype) if t.is_floating_point() else t)
                  for n, t in params.items()}
    gen = torch.Generator(dev)
    gen.manual_seed(int(seed))
    B, P = ids.shape
    toks = torch.empty((B, n_new), dtype=torch.int32, device=dev)
    with _bound(model, params):
        logits, caches = prefill_step(model, total_len)(
            torch.as_tensor(ids, dtype=torch.int32, device=dev))
        decode = decode_step(model)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(n_new):
            tok = _pick_impl(logits.float(), temp, gen, top_k, top_p)
            if eos_id is not None:
                done |= tok == eos_id
            toks[:, i] = tok
            if eos_id is not None and bool(done.all()):
                toks[:, i + 1:] = eos_id
                break
            if i + 1 < n_new:
                # the last pick needs no forward: its logits go unused
                logits, caches = decode(toks[:, i:i + 1], P + i, caches)
    return toks.cpu().numpy()


class GenerateMixin:
    """Adds `generate()` to decoder models exposing
    `forward_cached(ids, caches, pos)` and `init_caches(batch, max_len)`."""

    def _gen_setup(self, prompt_ids, max_new_tokens: int):
        """Normalize the prompt to (B, P) and enforce max_position:
        (ids, B, P, S) with S = P + max_new_tokens."""
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
        return ids, B, P, S

    def _gen_session(self, B: int, P: int, S: int, param_dtype,
                     opts) -> _GenSession:
        """The session for (B, P, S, param_dtype, opts), made if need be;
        kept last in `_gen_sessions`, whose order is least recently used
        first."""
        key = (B, P, S, param_dtype, opts)
        sess = self._gen_sessions.pop(key, None)
        if sess is None or not sess.fits(self):
            sess = None
            for k in [k for k, s in self._gen_sessions.items()
                      if not s.fits(self)]:
                del self._gen_sessions[k]
            while len(self._gen_sessions) >= MAX_SESSIONS:
                del self._gen_sessions[next(iter(self._gen_sessions))]
            sess = _GenSession(self, B, P, S, param_dtype, opts)
        self._gen_sessions[key] = sess
        return sess

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 use_graph: bool = True) -> np.ndarray:
        """Greedy (temperature=0) or sampled decoding, with optional
        top-k and/or nucleus (top-p) filtering when sampling.

        prompt_ids: int array (B, P).  Always returns a (B, P +
        max_new_tokens) int32 numpy array.  When `eos_id` is given, rows
        keep decoding until every row has emitted it; the remaining
        positions are then filled with eos_id.  On a CUDA device the
        prefill and the decode step run as captured CUDA graphs;
        `use_graph=False` launches each step from the host and keeps no
        state."""
        ids, B, P, S = self._gen_setup(prompt_ids, max_new_tokens)
        temp = float(temperature) if temperature and temperature > 0 \
            else 0.0
        vocab = self.cfg.vocab_size
        # greedy ignores the sampling controls, and out-of-range ones are
        # no-ops: normalise them so they do not make new programs
        if temp == 0.0 or not (top_k and 0 < top_k < vocab):
            top_k = None
        if temp == 0.0 or not (top_p and 0.0 < top_p < 1.0):
            top_p = None
        opts = (temp, top_k, top_p, eos_id)
        if use_graph:
            toks = self._gen_session(B, P, S, param_dtype, opts).run(
                ids, max_new_tokens, seed)
        else:
            toks = _generate_eager(self, ids, S, max_new_tokens, seed, opts,
                                   param_dtype)
        return np.concatenate([ids.astype(np.int32), toks], axis=1)
