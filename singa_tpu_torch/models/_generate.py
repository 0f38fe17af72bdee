"""Autoregressive generation with a static KV cache, ported from
``singa_tpu/models/_generate.py`` (``prefill_step``, ``decode_step``,
``_GenSession``, ``GenerateMixin.generate`` and ``generate_beam``,
``_pick_impl``, ``_beam_select`` and ``_beam_reorder``).

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

``generate_beam`` runs the same way as a `_BeamSession`: the (B·K)-row
prefill is one graph, one beam tick the other, replayed max_new_tokens
times (the reference's in-loop branches become computed-and-selected
work, which leaves the results unchanged), counted against the same
`MAX_SESSIONS`.

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

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from .. import autograd, faults
from ..graph import CapturedGraph, record
from ..graph import epoch as graph_epoch
from ..model import _sync, model_device
from ..obs import attr as obs_attr
from ..obs import events as obs_events

__all__ = ["GenerateMixin", "prefill_step", "decode_step", "resume_step"]

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


def resume_step(model):
    """Build the chunked-prefill closure of the paged serving engine:
    (ids (B, C), pos, caches) -> (logits (B, C, V), caches).  Unlike
    `prefill_step` it takes the caller's caches and a device scalar
    offset `pos`, so a prompt prefills as a sequence of fixed-(B, C)
    chunks: each chunk writes its k/v at [pos, pos + C) and attends the
    cache below pos + C (``cached_sdpa``'s bottom-right-aligned causal
    window).  `pos` stays a tensor even at 0: an int 0 would route the
    chunk through the prompt path instead of the cache."""

    def resume(ids, pos, caches):
        logits, caches = model.forward_cached(ids, caches=caches, pos=pos)
        return logits, caches

    return resume


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


class _Session:
    """A captured generation session of one shape: on a CUDA device a
    captured prefill and one captured step graph, replayed; on the CPU
    the same bodies run eagerly.  The first call runs the bodies eagerly
    (on a card, on the capture's side stream: the warm-up) and records
    each one's first run; on a card the second call captures them and
    every later one replays them.

    A subclass gives the static state, ``_load`` (write a call's inputs
    into it), ``_prefill``, the step body (the method ``_<_STEP>``, its
    graph ``graphs[_STEP]``), ``_n_steps`` and ``_result``."""

    _STEP = "decode"

    def __init__(self, model, param_dtype):
        self.model = model
        self.device = model_device(model).torch_device
        self.epoch = graph_epoch()
        self.masters = {n: t.detach() for n, t in model.get_params().items()}
        self.params = _static_params(model, param_dtype)
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

    def _cast_params(self) -> None:
        """Refresh the static cast weights from the masters."""
        for n, t in self.params.items():
            if t is not self.masters[n]:
                t.copy_(self.masters[n])

    def _generators(self):
        return ()

    def _step(self) -> None:
        getattr(self, "_" + self._STEP)()

    def run(self, n_new: int, *inputs):
        """One call: ``_load(*inputs)``, the prefill and ``_n_steps``
        steps, then ``_result()``.  The host seams of the step executor
        wrap the call: the ``device.execute`` fault site fires before
        anything runs, a ``graph.compile`` span covers the capture and a
        ``graph.execute`` span the run, and an installed ``obs.attr``
        ledger times it with the card synchronised around it."""
        name = f"{self.model.name}.{self._NAME}"
        faults.fire("device.execute", graph=name, step=self.calls)
        self._load(*inputs)
        steps = self._n_steps(n_new)
        led = obs_attr.get()
        if led is not None:
            _sync(self.device)
            t0 = time.perf_counter()
        with obs_events.span("graph.execute", graph=name, step=self.calls):
            if self.calls == 0:
                self._warm_up(steps)
            elif self.device.type != "cuda":
                self._prefill()
                for _ in range(steps):
                    self._step()
            else:
                if self.calls == 1:
                    with obs_events.span("graph.compile", graph=name):
                        self._capture()
                self.graphs["prefill"].replay()
                for _ in range(steps):
                    self.graphs[self._STEP].replay()
        if led is not None:
            _sync(self.device)
            led.note(self._NAME, time.perf_counter() - t0)
        self.calls += 1
        return self._result()

    def _warm_up(self, steps: int) -> None:
        """The first call: eager (on a card, on the capture's side
        stream), with the first run of each body recorded."""
        ctx = nullcontext()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            _, self.graphs["prefill"] = record("prefill", self._prefill)
            for i in range(steps):
                if i == 0:
                    _, self.graphs[self._STEP] = record(self._STEP,
                                                        self._step)
                else:
                    self._step()
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _capture(self) -> None:
        """Capture the prefill, then the step over the caches the
        prefill graph writes."""
        gens = self._generators()
        if gens and not hasattr(torch.cuda.CUDAGraph,
                                "register_generator_state"):
            raise RuntimeError(
                f"sampled generate() cannot be captured with torch "
                f"{torch.__version__}: its CUDAGraph has no "
                f"register_generator_state; pass use_graph=False")
        self.graphs["prefill"].capture(self._prefill, self._stream, gens)
        if self._STEP in self.graphs:
            self.graphs[self._STEP].capture(self._step, self._stream, gens)


class _GenSession(_Session):
    """generate() for one (batch, prompt length, total length, parameter
    dtype, pick options).

    Static state: the shared parameters in the dtype asked for (see
    `_static_params`), the prompt, the current token, its position, the
    eos flags and the (B, N) tokens.  A call runs the prefill (masters
    cast into the static parameters, prompt forward, first pick) and
    N - 1 decode steps (one token forward at the device position, next
    pick)."""

    _NAME = "generate"

    def __init__(self, model, batch: int, prompt_len: int, total_len: int,
                 param_dtype, opts):
        super().__init__(model, param_dtype)
        self.opts = opts
        self.prompt_len, self.total_len = prompt_len, total_len
        dev = self.device
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

    def _load(self, ids: np.ndarray, seed: int) -> None:
        self.ids.copy_(torch.as_tensor(ids, dtype=torch.int32))
        self.gen.manual_seed(int(seed))

    def _n_steps(self, n_new: int) -> int:
        return n_new - 1

    def _result(self) -> np.ndarray:
        """(B, n_new) int32 tokens."""
        return self.toks.cpu().numpy()

    def _generators(self):
        return (self.gen,) if self.opts[0] > 0 else ()

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
        self._cast_params()
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


class _BeamSession(_Session):
    """generate_beam() for one (batch, beams, prompt length, total
    length, parameter dtype, eos id): the (B·K)-row prefill is one graph,
    one beam tick (select, beam bookkeeping, cache reorder, decode) the
    other, replayed max_new_tokens times.

    The reference's search skips the cache reorder when no beam moved
    and skips the whole tick once every beam is done (two ``lax.cond``s).
    A graph has no branches, so the tick always runs both: an identity
    reorder gathers the same values, and a tick over beams that are all
    done only appends eos at cost 0 (frozen scores, lengths and
    sequences up to their lengths), so the returned sequences and scores
    are unchanged.  :func:`_beam_eager` keeps the branches."""

    _NAME = "generate_beam"
    _STEP = "tick"

    def __init__(self, model, batch: int, beams: int, prompt_len: int,
                 total_len: int, param_dtype, eos_id):
        super().__init__(model, param_dtype)
        self.K, self.eos_id = beams, eos_id
        self.prompt_len, self.total_len = prompt_len, total_len
        dev = self.device
        n = total_len - prompt_len
        V = model.cfg.vocab_size
        self.ids = torch.zeros((batch * beams, prompt_len),
                               dtype=torch.int32, device=dev)
        self.logits = torch.zeros((batch * beams, V), device=dev)
        # before the first expansion all K beams are identical: only
        # beam 0 may seed the frontier
        self.scores0 = torch.full((batch, beams), float("-inf"), device=dev)
        self.scores0[:, 0] = 0.0
        self.scores = self.scores0.clone()
        self.seqs = torch.zeros((batch, beams, n), dtype=torch.int64,
                                device=dev)
        self.done = torch.zeros((batch, beams), dtype=torch.bool, device=dev)
        self.gen_len = torch.zeros((batch, beams), dtype=torch.int64,
                                   device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.offsets = torch.arange(batch, device=dev)[:, None] * beams
        self.eos_row = None
        if eos_id is not None:
            self.eos_row = torch.where(torch.arange(V, device=dev) == eos_id,
                                       0.0, float("-inf"))

    def _load(self, ids: np.ndarray) -> None:
        self.ids.copy_(torch.as_tensor(np.repeat(ids, self.K, axis=0),
                                       dtype=torch.int32))

    def _n_steps(self, n_new: int) -> int:
        return n_new

    def _result(self):
        """(seqs (B, K, n), raw scores (B, K), done (B, K), lengths
        (B, K)) as numpy."""
        return tuple(t.cpu().numpy() for t in (self.seqs, self.scores,
                                               self.done, self.gen_len))

    def _prefill(self) -> None:
        self._cast_params()
        with _bound(self.model, self.params):
            logits, self.caches = prefill_step(self.model, self.total_len)(
                self.ids)
        self.logits.copy_(logits.float())
        self.scores.copy_(self.scores0)
        self.seqs.zero_()
        self.done.zero_()
        self.gen_len.zero_()
        self.i.zero_()

    def _select(self):
        """One expansion and its bookkeeping: (beam_idx, tok), both
        (B, K); scores, sequences, done flags and lengths updated."""
        beam_idx, tok, top = _beam_select(
            self.logits, self.scores, self.K,
            self.done if self.eos_id is not None else None, self.eos_row)
        n = self.seqs.shape[2]
        self.seqs.copy_(self.seqs.gather(
            1, beam_idx[:, :, None].expand(-1, -1, n)))
        self.done.copy_(self.done.gather(1, beam_idx))
        self.gen_len.copy_(self.gen_len.gather(1, beam_idx))
        self.seqs.index_copy_(2, self.i.reshape(1), tok[:, :, None])
        if self.eos_id is not None:
            # length counts the eos token itself, then freezes
            self.gen_len.copy_(torch.where(self.done, self.gen_len,
                                           self.i + 1))
            self.done |= tok == self.eos_id
        else:
            self.gen_len.copy_((self.i + 1).expand_as(self.gen_len))
        self.scores.copy_(top)
        return beam_idx, tok

    def _advance(self, beam_idx, tok, reorder: bool = True) -> None:
        """Reorder the caches onto the surviving beams (when `reorder`)
        and decode their tokens at position P + i."""
        if reorder:
            _beam_reorder(self.caches, (beam_idx + self.offsets).reshape(-1))
        with _bound(self.model, self.params):
            logits, _ = decode_step(self.model)(
                tok.reshape(-1, 1), self.prompt_len + self.i, self.caches)
        self.logits.copy_(logits.float())

    def _tick(self) -> None:
        self._advance(*self._select())
        self.i += 1


def _beam_select(logits, scores, k: int, done=None, eos_row=None):
    """One beam-search expansion: combine the (B*K, V) next-token logits
    with the (B, K) running scores, flatten each batch's K*V candidates,
    and keep the top K.  A finished beam (``done``) admits only eos at
    zero incremental cost (``eos_row``: 0 at eos, -inf elsewhere), so its
    raw score freezes.  Returns (beam_idx (B,K), tok (B,K), new_scores
    (B,K))."""
    B, K = scores.shape
    V = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    if done is not None:
        lp = torch.where(done[:, :, None], eos_row, lp)
    cand = scores[:, :, None] + lp
    top, flat = torch.topk(cand.reshape(B, K * V), k, dim=-1)
    return flat // V, flat % V, top


def _beam_reorder(caches, perm) -> None:
    """Gather the KV caches onto the surviving beams (batch axis 0), in
    place."""
    for kv in caches:
        for c in kv:
            c.copy_(c.index_select(0, perm))


def _beam_eager(model, ids: np.ndarray, total_len: int, n_new: int, K: int,
                eos_id, param_dtype):
    """generate_beam's search launched step by step from the host, with
    no state kept and the reference's two branches: the cache reorder is
    skipped when every beam kept its slot, and the search stops once
    every beam of every row is done.  (seqs, scores, done, lengths) as
    numpy, as `_BeamSession` returns them."""
    sess = _BeamSession(model, ids.shape[0], K, ids.shape[1], total_len,
                        None, eos_id)
    if param_dtype is not None:
        sess.params = {n: (t.to(param_dtype) if t.is_floating_point()
                           else t) for n, t in sess.masters.items()}
    sess._load(ids)
    sess._prefill()
    arange_k = torch.arange(K, device=sess.device)
    for _ in range(n_new):
        beam_idx, tok = sess._select()
        if eos_id is not None and bool(sess.done.all()):
            break
        sess._advance(beam_idx, tok,
                      reorder=bool((beam_idx != arange_k).any()))
        sess.i += 1
    return sess._result()


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

    def _session(self, key, make) -> _Session:
        """The session under `key` (generate()'s and generate_beam()'s
        share the `MAX_SESSIONS` cap), made by `make()` if need be; kept
        last in `_gen_sessions`, whose order is least recently used
        first."""
        sess = self._gen_sessions.pop(key, None)
        if sess is None or not sess.fits(self):
            sess = None
            for k in [k for k, s in self._gen_sessions.items()
                      if not s.fits(self)]:
                del self._gen_sessions[k]
            while len(self._gen_sessions) >= MAX_SESSIONS:
                del self._gen_sessions[next(iter(self._gen_sessions))]
            sess = make()
        self._gen_sessions[key] = sess
        return sess

    def _gen_session(self, B: int, P: int, S: int, param_dtype,
                     opts) -> _GenSession:
        """The generate() session for (B, P, S, param_dtype, opts)."""
        return self._session(
            (B, P, S, param_dtype, opts),
            lambda: _GenSession(self, B, P, S, param_dtype, opts))

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
        if max_new_tokens == 0:
            # nothing to generate: the prompt, as the reference's
            # length-0 decode loop returns it (no session, no forward)
            return ids.astype(np.int32)
        if use_graph:
            toks = self._gen_session(B, P, S, param_dtype, opts).run(
                max_new_tokens, ids, seed)
        else:
            toks = _generate_eager(self, ids, S, max_new_tokens, seed, opts,
                                   param_dtype)
        return np.concatenate([ids.astype(np.int32), toks], axis=1)

    @torch.no_grad()
    def generate_beam(self, prompt_ids, max_new_tokens: int,
                      num_beams: int = 4, length_penalty: float = 1.0,
                      eos_id: Optional[int] = None,
                      return_scores: bool = False,
                      param_dtype: Optional[torch.dtype] = None,
                      use_graph: bool = True):
        """Beam-search decoding: the K beams ride the batch axis, so the
        prefill is generate()'s over a (B*K)-row batch.  On a CUDA
        device the prefill and one beam tick (expansion, beam
        bookkeeping, cache reorder, decode) run as captured CUDA graphs,
        the tick replayed max_new_tokens times (`_BeamSession`);
        `use_graph=False` launches each step from the host and keeps no
        state.

        Once a beam emits `eos_id` its hypothesis is frozen: its only
        expansion is eos at zero cost, so its RAW cumulative score stays
        constant — but it remains in the single K-wide frontier and can
        still be evicted by K continuing candidates with higher raw
        scores.  `length_penalty` is applied only at the END, ranking
        the K survivors by cumulative logprob / length**length_penalty.
        Returns the best survivor per batch row — shape (B, P +
        max_new_tokens), eos-padded; with `return_scores`, also the (B,)
        cumulative logprob of each returned hypothesis (its exact sum of
        chosen-token logprobs)."""
        K = int(num_beams)
        if K < 1:
            raise ValueError(f"num_beams must be >= 1, got {K}")
        ids, B, P, S = self._gen_setup(prompt_ids, max_new_tokens)
        if use_graph:
            seqs, scores, done, gen_len = self._session(
                ("beam", B, K, P, S, param_dtype, eos_id),
                lambda: _BeamSession(self, B, K, P, S, param_dtype, eos_id)
            ).run(max_new_tokens, ids)
        else:
            seqs, scores, done, gen_len = _beam_eager(
                self, ids, S, max_new_tokens, K, eos_id, param_dtype)
        final = scores / np.maximum(gen_len, 1).astype(np.float32) \
            ** length_penalty
        best = final.argmax(axis=1)
        out = np.full((B, S), eos_id if eos_id is not None else 0, np.int32)
        out[:, :P] = ids
        for b in range(B):
            n = int(gen_len[b, best[b]]) if eos_id is not None \
                else max_new_tokens
            out[b, P:P + n] = seqs[b, best[b], :n]
            if eos_id is not None and bool(done[b, best[b]]):
                out[b, P + n:] = eos_id
        if return_scores:
            return out, scores[np.arange(B), best]
        return out
