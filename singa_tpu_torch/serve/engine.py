"""ServeEngine — continuous-batching inference over a paged KV arena,
ported from ``singa_tpu/serve/engine.py``.

The engine turns the one-session decode loop of ``models/_generate.py``
into a multi-request server.  For a given (model, num_slots, max_len,
block_size) it runs TWO programs (a speculative engine three, a spill
tier adds the restore program of ``serve/mem.py``), each on static
device buffers, and on a card each captured as one CUDA graph:

* **prefill-chunk** — ``block_size`` tokens of one request's prompt at
  a block-aligned device offset: the slot's block-table row is gathered
  into a dense cache view, the chunk's k/v are written at
  [pos, pos + block_size), the chunk's last valid token is picked and
  written to the slot's entry of the token vector, and exactly ONE
  physical block is scattered back (``ops.kv_cache.scatter_block_kv``).
  A prompt prefills as ``ceil(len / block_size)`` dispatches — and a
  request whose leading prompt blocks are already resident (prefix
  cache) skips those entirely.
* **decode-over-block-tables** — ONE token for every slot per replay:
  the (num_slots, max_blocks) block tables gather every slot's dense
  view, per-slot positions drive RoPE offsets and attention limits as
  (num_slots,) vectors, and each slot's new k/v is scattered to
  ``[table[slot, pos // bs], pos % bs]`` (``scatter_token_kv``).
  Inactive slots are masked — position clamped to 0, writes redirected
  to the null block, token entries frozen — so a half-empty arena
  replays the same graph.

A program's first dispatch runs eagerly (on a card, on a side stream)
and is recorded with ``graph.record``; the second captures it and every
later dispatch replays it — the pattern of ``_GenSession``
(``serve/program.py``).  :meth:`compiled_counts` reads (1, 1) after
warm-up however many requests come and go: the counterpart of the
reference's jit-cache invariant.  What a program reads is on the device at fixed addresses:
the weights (the masters, or one copy cast to ``param_dtype`` at
construction), the arena, the block tables, positions and active flags
(``BlockPool``), the (num_slots,) token vector, and the chunk's ids,
offset, last index and slot.  Host-side updates write into those
tensors in place — never a rebinding, which the next replay would not
see — and the chunk's inputs go up in one non-blocking copy from pinned
memory.  The only host syncs are the designed fetches: one
(num_slots,) token read per decode tick and one per admission.  The
chunk offset stays a tensor even at 0, so every chunk attends through
``cached_sdpa`` as in the reference; neither program runs the flash
kernel.

Greedy decode through the engine is token-identical to
``generate()`` on the CPU in f32 and to the reference engine.

Admission counts FREE BLOCKS, not slots: a request needs a table row
AND enough blocks for its prompt (minus the shared prefix), and decode
grows a slot by one block when its position crosses a block boundary.
When growth finds no free or evictable block, the youngest running
request is PREEMPTED — its blocks are released and it re-queues at the
head, to be re-prefilled later.

A preempted or recovered request is re-admitted as in the reference:
prompt + tokens-so-far re-prefilled in chunks, the last chunk's pick
delivered as its next token.  Greedy decode makes that idempotent; on
a card ``chip_smoke.py`` holds the streams bitwise equal to an
uninterrupted run's through a recovery and under preemption.

Resilience, every path exercised by deterministic chaos tests
(``singa_tpu_torch.faults``):

* **retry** — transient dispatch failures (RuntimeError/OSError before
  the program launches) are retried with bounded exponential backoff;
  the ``serve.prefill``/``serve.decode`` injection sites fire on the
  host *before* the program, so an injected fault leaves the arena
  intact and the retry re-dispatches the same tick.  A real failure
  inside a replay escalates.
* **quarantine** — a request whose prefill (or admission-time block
  allocation, site ``serve.block_alloc``) keeps failing is marked
  ``failed`` on its handle instead of crashing the engine.
* **shedding** — queued requests whose deadline will expire before they
  could plausibly reach a slot are shed at the step boundary.
* **recovery** — when decode or a decode-time block allocation dies
  past retries, or a Heartbeat detects a hang (``recover_on_hang``),
  the arena is reset IN PLACE (the same storage zeroed, tables,
  refcounts and prefix cache emptied, so nothing is recaptured) and
  every in-flight request is re-prefilled from prompt + tokens.
* **drain/close** — ``drain()`` refuses new submissions while
  completing everything in the system; ``close()`` drains and releases
  the arena and the graphs.

Every request gets a trace id (``handle.trace_id``) activated around
its admission, prefill chunks, token deliveries and eviction; the
engine keeps a :class:`~singa_tpu_torch.obs.flight.FlightRecorder`
ring, dumped next to ``record_store`` on each quarantine or recovery
and referenced from the ``incident`` record.  With no ``record_store``
and no sink the engine performs zero file writes.

Speculative decoding (``draft_model=``, ``spec_k=``) replaces the
per-tick decode with a **verify** round, the third program
(``serve/spec.py``): the draft proposes k tokens per slot over its own
arena (a second pool on the same block tables), the target scores all
k + 1 window positions in one forward, the longest matching greedy
prefix commits and rejected positions roll back by truncating the
slot's position.  The round's per-slot accepted counts and the
target's picks land in one static (num_slots, k + 2) tensor, fetched
in one designed sync.  A verify failure past retries falls back to a
plain decode tick (site ``serve.verify``), whose program is made at
its first use; :meth:`spec_compiled_counts` reads (prefill, decode,
verify, handoff).

The memory hierarchy (``serve/mem.py``): ``kv_dtype="int8"`` stores
the arena as int8 codes plus per-position scales (and
``draft_kv_dtype`` the draft's), ``spill_blocks=N`` keeps up to N
evicted prefix blocks in pinned host memory and restores them on a
re-hit through the restore program.  The spill store outlives
recovery.

Disaggregated serving: the engine is also the worker unit of
:mod:`singa_tpu_torch.serve.disagg` — a prefill pool ticks with
``step(decode=False)`` and hands finished prefills to a decode pool
through :meth:`extract_handoff`/:meth:`inject_handoff`.  The KV leaves
through the handoff program, one more captured program, which gathers
one slot's dense view into a static buffer (made at the first handoff);
refcounts and prefix-cache keys transfer with the blocks.  Same-config
workers share one :class:`SharedPrograms` (``programs=``): the served
weight copy and the model's step closures.  A CUDA graph reads its own
engine's static tensors by address, so each worker still captures its
own programs: a tier costs one weight copy, and one capture per worker
and program (the reference's costs one compile).  The reference's
``lower_programs`` reads XLA lowerings and has no counterpart.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from contextlib import nullcontext
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import faults
from ..autotune import table as autotune_table
from ..model import _sync, model_device
from ..models._generate import _bound, decode_step, resume_step
from ..obs import attr as obs_attr
from ..obs import events
from ..obs import flight as obs_flight
from ..obs import record as obs_record
from ..obs import trace as obs_trace
from ..ops import kv_cache as kv_ops
from ..utils import failure
from ..utils.failure import Heartbeat
from . import mem as serve_mem
from . import spec
from .metrics import ServeMetrics
from .program import Program
from .scheduler import (EVICTED, FAILED, FINISHED, QUEUED, RUNNING,
                        QueueFull, Request, RequestHandle, Scheduler,
                        eta_first_token)
from .slots import BlockPool

__all__ = ["ServeEngine", "QueueFull", "EngineClosed", "SharedPrograms"]

#: distinguishes engines built in the same second+pid (run_id suffix)
_ENGINE_SEQ = itertools.count()


class EngineClosed(RuntimeError):
    """submit()/step() refused: the engine is draining or closed."""


class SharedPrograms(NamedTuple):
    """What one engine lends another (``ServeEngine(...,
    programs=template.programs())``) so that a disaggregated worker pool
    serves from ONE weight copy: the served weights (the masters or the
    one ``param_dtype`` copy, and the draft's) and the model's step
    closures.  Each engine still captures its own programs — a CUDA
    graph reads its engine's arena, tables and token vector by address —
    so every worker's :meth:`ServeEngine.compiled_counts` stays at
    (1, 1).  Sharing requires the SAME model and draft objects, the same
    block size, ``spec_k``, ``param_dtype`` and arena storage formats:
    what the closures and the weight copy were made for."""

    model_ref: object
    block_size: int
    params: dict
    resume: object
    decode: object
    #: speculative decoding: the draft the closures capture (None for a
    #: plain engine), its weights, the verify window and the spec
    #: prefill / verify closures
    draft_ref: object = None
    dparams: Optional[dict] = None
    spec_k: int = 0
    spec_prefill: object = None
    verify: object = None
    #: arena storage formats (None = full precision, "int8")
    kv_dtype: object = None
    draft_kv_dtype: object = None
    param_dtype: object = None


class ServeEngine:
    """Continuous-batching engine over one decoder model.

        eng = ServeEngine(model, num_slots=8, max_len=256, block_size=32)
        h = eng.submit(prompt_ids, max_new_tokens=64, deadline_s=30.0)
        eng.run_until_idle()
        full = h.result()              # prompt + generated tokens

    ``step()`` advances the whole arena by one decode tick (evict →
    admit/prefill → decode), delivering one token to every live request
    and invoking their streaming ``on_token`` callbacks.

    The engine runs on the device the model was built on: the card,
    unless the model was built on ``create_device("cpu")``.
    ``num_blocks`` sizes the physical block pool (default: capacity
    parity with a fixed ``(num_slots, max_len)`` arena); a SMALLER pool
    with MORE slots is how paging admits more concurrent requests in
    the same memory.  ``share_prefix=False`` disables prefix-cache
    sharing (every prompt block is private).  ``param_dtype`` (e.g.
    ``torch.bfloat16``) serves a copy of the weights cast once at
    construction (the draft's too); the arena takes the dtype the
    model's caches take under it.  ``draft_model``/``spec_k`` make a
    speculative engine (``spec_k=None`` with a draft takes the
    best-config table's window for this model and device,
    ``autotune.table.resolve_spec_k``);
    ``kv_dtype``/``draft_kv_dtype="int8"`` quantize the target / draft
    arena; ``spill_blocks`` sizes the host
    spill store; ``programs`` (another engine's :meth:`programs`)
    serves from that engine's weight copy, as the workers of a
    disaggregated tier do.

    Decoding is greedy — the serving counterpart of
    ``generate(temperature=0)``.
    """

    def __init__(self, model, num_slots: int, max_len: int, *,
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 share_prefix: bool = True,
                 max_queue: Optional[int] = None,
                 param_dtype=None,
                 heartbeat_timeout_s: Optional[float] = None,
                 on_failure=None,
                 max_dispatch_retries: int = 2,
                 backoff_base: float = 0.05,
                 backoff_max: float = 1.0,
                 recover_on_hang: bool = False,
                 max_recoveries: int = 2,
                 record_store: Optional[str] = None,
                 run_id: Optional[str] = None,
                 programs=None,
                 draft_model=None, spec_k: Optional[int] = None,
                 kv_dtype=None, draft_kv_dtype=None,
                 spill_blocks: Optional[int] = None,
                 _sleep: Callable[[float], None] = time.sleep):
        self.model = model
        # speculative decoding (serve/spec.py): a draft turns the
        # per-tick decode into a verify-k round.  spec_k=None with a
        # draft asks the committed best-config table how deep
        if draft_model is not None and spec_k is None:
            spec_k = autotune_table.resolve_spec_k(model)
        if spec_k is None:
            spec_k = 0
        if (draft_model is None) != (spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH draft_model and "
                f"spec_k >= 1 (got draft_model="
                f"{'set' if draft_model is not None else 'None'}, "
                f"spec_k={spec_k})")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.draft_model = draft_model
        self.spec_k = int(spec_k)
        max_pos = getattr(getattr(model, "cfg", None), "max_position", None)
        if max_pos is not None and max_len > max_pos:
            raise ValueError(
                f"max_len ({max_len}) exceeds the model's max_position "
                f"({max_pos})")
        self.share_prefix = bool(share_prefix)
        self.sched = Scheduler(
            max_queue=2 * num_slots if max_queue is None else max_queue)
        # the incident flight ring: always recording (bounded in-memory,
        # zero file I/O), registered for fault-fire broadcasts; dumps
        # happen only when record_store names a place for them
        self.flight = obs_flight.register(obs_flight.FlightRecorder())
        self.metrics = ServeMetrics(flight=self.flight)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._on_failure = on_failure
        self.max_dispatch_retries = int(max_dispatch_retries)
        if self.max_dispatch_retries < 0:
            raise ValueError(f"max_dispatch_retries must be >= 0, got "
                             f"{max_dispatch_retries}")
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.recover_on_hang = bool(recover_on_hang)
        self.max_recoveries = int(max_recoveries)
        self.record_store = record_store
        self.run_id = run_id or \
            f"{obs_record.new_run_id('serve')}-e{next(_ENGINE_SEQ)}"
        self._sleep = _sleep
        self._draining = False
        self._closed = False
        # set by the Heartbeat monitor thread, consumed at the next
        # step boundary by the step thread (which owns the arena)
        self._recover_flag = threading.Event()
        self._recoveries = 0
        self._incident_seq = itertools.count()
        self._tick_ewma: Optional[float] = None   # measured step() wall s
        # measured accepted-tokens-per-tick per slot (EWMA): 1.0 for a
        # plain engine, up to spec_k + 1 under speculation; the shed eta
        # divides by it (scheduler.eta_first_token)
        self._tpt_ewma: Optional[float] = None
        # admission-cadence hint from an external tier loop (the
        # disaggregated Router pushes its measured round time here): the
        # shed eta uses the slower of this and the engine's own tick
        self.tick_hint_s: Optional[float] = None
        self._device = model_device(model).torch_device
        self._kv_dtype = serve_mem.normalize_kv_dtype(kv_dtype)
        self._draft_kv_dtype = (self._kv_dtype if draft_kv_dtype is None
                                else serve_mem.normalize_kv_dtype(
                                    draft_kv_dtype))
        self._param_dtype = param_dtype
        if programs is not None:
            self._check_shared(programs, block_size)
            self._params, self._dparams = programs.params, programs.dparams
        else:
            self._snapshot_weights(param_dtype)
        # the arena takes the dtype the model's caches take under the
        # served weights
        with _bound(model, self._params):
            arena_dtype = model.init_caches(1, 1)[0][0].dtype
        # the memory hierarchy (serve/mem.py): the host spill store is
        # content-addressed (chain keys) and so outlives arena recovery
        if spill_blocks is not None and spill_blocks < 1:
            raise ValueError(
                f"spill_blocks must be >= 1 (or None to disable the "
                f"spill tier), got {spill_blocks}")
        self._spill = (serve_mem.SpillStore(spill_blocks)
                       if spill_blocks is not None else None)
        self.pool = BlockPool(model, num_slots, max_len,
                              block_size=block_size, num_blocks=num_blocks,
                              dtype=arena_dtype, draft_model=draft_model,
                              kv_dtype=self._kv_dtype,
                              draft_kv_dtype=self._draft_kv_dtype,
                              spill=self._spill)
        self._wire_spill()
        self._running: Dict[int, Request] = {}      # slot -> request
        dev, bs = self._device, self.pool.block_size
        # device-resident per-slot last tokens: written by prefill (the
        # request's first token) and decode (each next token); the host
        # only ever FETCHES this small vector
        self._toks = torch.zeros((num_slots,), dtype=torch.int64,
                                 device=dev)
        # the chunk's inputs, one static vector written by one copy:
        # ids (bs), then the offset, the last valid index and the slot
        self._chunk = torch.zeros((bs + 3,), dtype=torch.int64, device=dev)
        if programs is not None:
            self._resume, self._dec = programs.resume, programs.decode
            self._spec_prefill = programs.spec_prefill
            self._spec_verify = programs.verify
        else:
            self._resume = resume_step(model)
            self._dec = decode_step(model)
            self._spec_prefill = self._spec_verify = None
            if draft_model is not None:
                self._spec_prefill = spec.make_spec_prefill(
                    model, draft_model, bs)
                self._spec_verify = spec.make_verify(model, draft_model,
                                                     self.spec_k, bs)
        self._prefill = Program("prefill_chunk", self._prefill_body, dev)
        # on a spec engine the plain decode is the serve.verify
        # fallback: its program is made at its first dispatch
        self._decode = Program("decode", self._decode_body, dev)
        self._verify = None
        if draft_model is not None:
            # the spec prefill writes both arenas; the verify round's
            # outputs: per-slot accepted counts (column 0) and the
            # target's k + 1 picks, one static tensor fetched at once
            self._spec_out = torch.zeros((num_slots, self.spec_k + 2),
                                         dtype=torch.int64, device=dev)
            self._verify = Program("verify", self._verify_body, dev)
        # the handoff program (disaggregated tier): reads the slot in
        # `_hslot` and writes its dense per-layer views into `_hout`,
        # static buffers made at the first handoff (only a prefill
        # worker ever extracts)
        self._hslot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._hout: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self._handoff = Program("handoff_gather", self._handoff_body, dev)

    def _snapshot_weights(self, param_dtype) -> None:
        """The served weights, snapshotted once: the masters, or one
        copy cast to ``param_dtype`` (decode is weight-read bound); the
        draft's the same way, self-speculation reading the target's."""
        masters = {n: t.detach() for n, t in self.model.get_params().items()}
        if not masters:
            raise ValueError("model has no parameters to serve")
        self._params = self._cast(masters, param_dtype)
        self._dparams = None
        if self.draft_model is self.model:
            self._dparams = self._params
        elif self.draft_model is not None:
            dmasters = {n: t.detach()
                        for n, t in self.draft_model.get_params().items()}
            if not dmasters:
                raise ValueError("draft model has no parameters to serve")
            self._dparams = self._cast(dmasters, param_dtype)

    def _check_shared(self, programs: SharedPrograms,
                      block_size: int) -> None:
        """Refuse a ``programs=`` bundle made for another model, draft,
        block size, verify window, weight dtype or arena format."""
        if programs.model_ref is not self.model:
            raise ValueError(
                "programs= sharing requires the SAME model object "
                "(the step closures capture its cached forward)")
        if programs.block_size != block_size:
            raise ValueError(
                f"programs= sharing requires matching block_size "
                f"(template {programs.block_size}, this engine "
                f"{block_size})")
        if programs.draft_ref is not self.draft_model or \
                programs.spec_k != self.spec_k:
            raise ValueError(
                "programs= sharing requires the SAME draft model "
                "object and spec_k (the verify program's closures "
                f"capture both; template spec_k={programs.spec_k}, "
                f"this engine spec_k={self.spec_k})")
        if programs.kv_dtype != self._kv_dtype or \
                programs.draft_kv_dtype != self._draft_kv_dtype:
            raise ValueError(
                "programs= sharing requires matching arena storage "
                "formats (template kv_dtype="
                f"{programs.kv_dtype!r}/draft "
                f"{programs.draft_kv_dtype!r}, this engine "
                f"{self._kv_dtype!r}/{self._draft_kv_dtype!r}) — the "
                "workers of one tier hand each other blocks of one "
                "layout")
        if programs.param_dtype != self._param_dtype:
            raise ValueError(
                f"programs= sharing requires matching param_dtype "
                f"(template {programs.param_dtype}, this engine "
                f"{self._param_dtype}): the shared weight copy was cast "
                f"once, for the template")

    @staticmethod
    def _cast(masters, param_dtype):
        """The masters, or one copy of them cast to ``param_dtype``."""
        if param_dtype is None:
            return masters
        return {n: (t.to(param_dtype) if t.is_floating_point() else t)
                for n, t in masters.items()}

    # -- the programs ------------------------------------------------------
    def _prefill_body(self) -> None:
        """One block-aligned chunk of one request's prompt: gather the
        slot's dense view, run the cached forward at the device offset,
        pick the chunk's last valid token (only the final chunk's pick
        survives), and scatter the ONE block this chunk filled back.  A
        spec engine runs the same chunk through the draft into the
        draft arena too (``spec.make_spec_prefill``)."""
        pool, bs = self.pool, self.pool.block_size
        ids = self._chunk[:bs].reshape(1, bs)
        start, last, slot = (self._chunk[bs + i] for i in range(3))
        if self._spec_prefill is not None:
            self._spec_prefill(self._params, self._dparams, ids, start, last,
                               slot, pool.tables, self._toks, pool.caches,
                               pool.draft_caches)
            return
        with _bound(self.model, self._params):
            row = pool.tables.index_select(0, slot.reshape(1))   # (1, MB)
            logits, dense = spec.resume_on_row(self._resume, ids, start,
                                               row, pool.caches)
            tok = torch.argmax(
                logits.index_select(1, last.reshape(1))[:, 0].float(),
                dim=-1)
            self._toks.index_copy_(0, slot.reshape(1), tok)
            spec.scatter_chunk(row, start, pool.caches, dense, bs)

    def _decode_body(self) -> None:
        """One token for every slot.  Inactive slots are masked:
        position clamped to 0 and the write redirected to the null
        block (their table row may point at blocks now owned by OTHER
        requests), and their token entry frozen."""
        pool, bs = self.pool, self.pool.block_size
        active, pos, toks = pool.active, pool.pos, self._toks
        with _bound(self.model, self._params):
            posc = torch.where(active, pos, 0)
            dense = [kv_ops.gather_block_kv(ck, cv, pool.tables)
                     for ck, cv in pool.caches]
            logits, dense = self._dec(toks[:, None], posc, dense)
            picked = torch.argmax(logits.float(), dim=-1)
            toks.copy_(torch.where(active, picked, toks))
            wb = pool.tables.gather(1, (posc // bs)[:, None])[:, 0]
            wb = torch.where(active, wb, 0)
            off = torch.where(active, posc % bs, 0)
            rows = torch.arange(pos.shape[0], device=pos.device)
            for (ck, cv), (dk, dv) in zip(pool.caches, dense):
                kv_ops.scatter_token_kv(ck, cv, wb, off, dk[rows, posc],
                                        dv[rows, posc])
            pos.copy_(torch.where(active, pos + 1, pos))

    def _handoff_body(self) -> None:
        """One slot's dense per-layer views (target, then draft),
        gathered through its block-table row into the static ``_hout``
        buffers.  Reads the arena only: a failed handoff leaves the
        source valid for a re-route."""
        pool = self.pool
        row = pool.tables.index_select(0, self._hslot)
        caches = pool.caches + (pool.draft_caches or [])
        for (ck, cv), (ok, ov) in zip(caches, self._hout):
            dk, dv = kv_ops.gather_block_kv(ck, cv, row)
            ok.copy_(dk)
            ov.copy_(dv)

    def _verify_body(self) -> None:
        """One speculative round over every slot (``spec.make_verify``):
        writes both arenas' windows, the token vector and the positions
        in place, and the round's (accepted, picks) into ``_spec_out``."""
        pool = self.pool
        self._spec_verify(self._params, self._dparams, self._toks, pool.pos,
                          pool.active, pool.tables, pool.caches,
                          pool.draft_caches, self._spec_out)

    def _prefill_chunk(self, chunk: np.ndarray, start: int,
                       slot: int) -> None:
        """Write one chunk's inputs into the static vector (one
        non-blocking copy from pinned memory) and dispatch the
        prefill-chunk program."""
        bs = self.pool.block_size
        host = torch.zeros((bs + 3,), dtype=torch.int64)
        host[:chunk.size] = torch.from_numpy(chunk.astype(np.int64))
        host[bs:] = torch.tensor([start, chunk.size - 1, slot])
        if self._device.type == "cuda":
            host = host.pin_memory()
        self._chunk.copy_(host, non_blocking=True)
        self._prefill()

    # -- introspection ----------------------------------------------------
    def compiled_counts(self):
        """(prefill, decode) programs made (``Program.count``: 1 from a
        program's first dispatch on; a card captures it at the second).
        Both stay at 1 after warm-up however many requests come and go,
        across preemption and arena recovery."""
        return (self._prefill.count, self._decode.count)

    def handoff_compiled_count(self) -> int:
        """Programs made for the handoff gather: 0 until this engine's
        first handoff, 1 after — never more (fixed shapes)."""
        return self._handoff.count

    def spec_compiled_counts(self):
        """(prefill, decode, verify, handoff) programs made: the fixed
        program set of a speculative engine.  ``decode`` is 0 until a
        ``serve.verify`` fault forces a plain-decode fallback tick,
        ``handoff`` is 0 outside a disaggregated tier; no entry ever
        exceeds 1."""
        return (self._prefill.count, self._decode.count,
                self._verify.count if self._verify is not None else 0,
                self._handoff.count)

    def programs(self) -> SharedPrograms:
        """What this engine lends another same-model, same-block-size
        engine through ``programs=`` — see :class:`SharedPrograms`."""
        return SharedPrograms(
            model_ref=self.model, block_size=self.pool.block_size,
            params=self._params, resume=self._resume, decode=self._dec,
            draft_ref=self.draft_model, dparams=self._dparams,
            spec_k=self.spec_k, spec_prefill=self._spec_prefill,
            verify=self._spec_verify, kv_dtype=self._kv_dtype,
            draft_kv_dtype=self._draft_kv_dtype,
            param_dtype=self._param_dtype)

    @property
    def pending(self) -> int:
        """Requests still in flight (queued + running)."""
        return self.sched.depth + len(self._running)

    # -- disaggregated-tier hooks (serve/disagg) ---------------------------
    def running_items(self) -> List[Tuple[int, Request]]:
        """(slot, request) pairs occupying slots, in slot order: what a
        prefill worker has ready to hand off (a snapshot: handing off
        mutates the running map)."""
        return sorted(self._running.items())

    def withdraw(self, slot: int) -> Request:
        """Remove a RUNNING request without finishing it: its slot and
        blocks are released and it goes back to QUEUED with its prompt
        and tokens so far — the router's re-route primitive (greedy
        replay elsewhere reproduces the stream, as after preemption)."""
        req = self._running.pop(slot)
        self.pool.release(slot)
        req.slot = None
        req.state = QUEUED
        return req

    def can_accept_handoff(self, pkg) -> bool:
        """Whether :meth:`inject_handoff` could take ``pkg`` now (a free
        slot and coverable blocks, resident shared prefix counted);
        side-effect free.  See ``serve/disagg/handoff.py``."""
        from .disagg import handoff
        return handoff.can_accept(self, pkg)

    def extract_handoff(self, slot: int):
        """Pull a finished prefill out of this engine as a
        :class:`~singa_tpu_torch.serve.disagg.handoff.HandoffPackage`:
        the slot's blocks are gathered by the handoff program and copied
        into the package, then slot and blocks are released here."""
        from .disagg import handoff
        return handoff.extract(self, slot)

    def inject_handoff(self, pkg) -> bool:
        """Admit a prefilled request from another engine mid-stream:
        blocks whose prefix chain keys are resident map copy-free, the
        rest are written into freshly allocated blocks in place.  False
        when capacity is lacking (the router parks the handoff)."""
        from .disagg import handoff
        return handoff.inject(self, pkg)

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids, *, max_new_tokens: int,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_token=None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Queue one generation request; returns its handle.

        Raises :class:`QueueFull` when the wait queue is at capacity
        (admission out of the queue happens only at ``step()``
        boundaries, so a burst of more than ``max_queue`` un-stepped
        submissions is rejected even while slots are free; default
        ``2 * num_slots``).  Raises ``ValueError`` when the request
        cannot ever fit the arena (prompt + budget past ``max_len``) or
        ``max_new_tokens < 1``.  Raises :class:`EngineClosed` while
        draining or after ``close()``."""
        if self._closed:
            raise EngineClosed("submit() on a closed engine")
        if self._draining:
            raise EngineClosed(
                "engine is draining — new submissions are refused while "
                "in-flight requests complete")
        req = Request(prompt_ids, max_new_tokens, deadline_s, eos_id,
                      on_token)
        # one trace per request: every event the engine emits about it
        # carries this id (handle.trace_id)
        req.trace_id = trace_id or f"{self.run_id}/r{req.rid}"
        p = req.prompt.size
        # a speculative engine needs spec_k positions of headroom: the
        # request's LAST verify round may still write a full k+1 window
        # past its final accepted token, inside the slot's dense view
        if p + req.max_new_tokens + self.spec_k > self.pool.max_len:
            k_note = (f" + spec_k ({self.spec_k})" if self.spec_k
                      else "")
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({req.max_new_tokens})"
                f"{k_note} = {p + req.max_new_tokens + self.spec_k} "
                f"exceeds max_len ({self.pool.max_len})")
        with obs_trace.activate(req.trace_id):
            try:
                self.sched.offer(req)
            except QueueFull:
                self.metrics.on_reject()
                raise
            self.metrics.on_submit()
        return req.handle

    def resubmit(self, prompt_ids, tokens, *, max_new_tokens: int,
                 deadline_s: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 ttft_s: Optional[float] = None) -> RequestHandle:
        """Re-admit a request that was already in flight somewhere else,
        with its generated ``tokens`` pre-installed: it re-enters at the
        HEAD of the queue and the next admission re-prefills prompt +
        tokens, so greedy replay continues the stream bit-identically.
        ``ttft_s`` (the original first-token latency) is preserved.  Not
        counted as a new submission."""
        if self._closed:
            raise EngineClosed("resubmit() on a closed engine")
        if self._draining:
            raise EngineClosed(
                "engine is draining — new submissions are refused while "
                "in-flight requests complete")
        req = Request(prompt_ids, max_new_tokens, deadline_s, eos_id,
                      None)
        req.tokens = [int(t) for t in tokens]
        req.trace_id = trace_id or f"{self.run_id}/r{req.rid}"
        req.ttft_s = ttft_s
        p = req.prompt.size
        if p + req.max_new_tokens + self.spec_k > self.pool.max_len:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_len ({self.pool.max_len})")
        with obs_trace.activate(req.trace_id):
            self.sched.requeue_front([req])
            self.flight.note("counter", "serve.resubmit", rid=req.rid,
                             replayed=len(req.tokens))
        return req.handle

    # -- the engine loop ---------------------------------------------------
    def step(self, *, decode: bool = True) -> int:
        """One continuous-batching tick: recovery (if requested by the
        hang watchdog) → deadline eviction → overload shedding →
        admission (prefill queued requests into free slots while free
        blocks cover them) → block-table growth → one decode over all
        active slots.  Returns the number of tokens delivered.

        ``decode=False`` stops after admission — a prefill worker's
        tick: freshly prefilled requests (their first token delivered)
        stay in their slots for the router to hand off.  Deadline
        eviction still applies to them."""
        if self._closed:
            raise EngineClosed("step() on a closed engine")
        with events.span("serve.step"):
            now = time.monotonic()
            delivered = 0

            # 0. hang recovery — the Heartbeat monitor thread can only
            #    REQUEST it; the reset runs here, on the step thread,
            #    which owns the arena
            if self._recover_flag.is_set():
                self._recover_flag.clear()
                self._recover("heartbeat")

            # 1. deadline eviction — queued requests that died waiting
            #    and running requests past their deadline vacate first
            for req in self.sched.expire_queued(now):
                with obs_trace.activate(req.trace_id):
                    self.metrics.on_evict("deadline")
            for slot in [s for s, r in self._running.items()
                         if r.expired(now)]:
                req = self._running[slot]
                req.finish_reason = "deadline"
                self._finalize(slot, evicted=True)

            # 1b. deadline-aware overload shedding
            for req in self.sched.shed_overload(now, self._eta_first_token):
                with obs_trace.activate(req.trace_id):
                    self.metrics.on_evict("shed")

            # 2. admission — the head-of-queue request must be coverable
            #    by free + evictable blocks (FIFO: a too-big head blocks
            #    the line rather than being overtaken)
            while self.pool.free_count:
                req = self.sched.peek()
                if req is None or not self._admittable(req):
                    break
                self.sched.pop_for_admission()
                delivered += self._admit(req)

            # 3. block-table growth + one decode tick over the whole
            #    arena; a decode (or a decode-time block allocation)
            #    that died past its retry budget escalates to an arena
            #    reset + re-prefill instead of crashing the engine
            if self._running and decode:
                try:
                    self._ensure_blocks()
                    if self._running:
                        delivered += (self._spec_tick()
                                      if self._verify is not None
                                      else self._decode_tick())
                except (RuntimeError, OSError) as e:
                    if isinstance(e, failure.FailureDetected):
                        raise
                    self._recover(f"decode: {type(e).__name__}: {e}")

            # the spill copies are done once the tick's token fetch has
            # synchronised the stream: settling them waits for nothing
            if self._spill is not None:
                self._spill.settle()

            self.metrics.on_step(self.sched.depth, self.pool.active_count,
                                 self.pool.blocks_in_use,
                                 self.pool.blocks_in_use_bytes)
            dt = time.monotonic() - now
            self._tick_ewma = dt if self._tick_ewma is None else \
                0.8 * self._tick_ewma + 0.2 * dt
        return delivered

    def _eta_first_token(self, position: int) -> float:
        """Seconds until the queued request at ``position`` could
        plausibly deliver its first token (:func:`scheduler.
        eta_first_token` at the admission period — the slower of the
        measured tick EWMA and the ``tick_hint_s`` a multi-pool router
        pushes — and the accepted tokens per tick); 0.0 before any
        timing evidence exists."""
        tick = self._tick_ewma
        if self.tick_hint_s:
            tick = (self.tick_hint_s if tick is None
                    else max(tick, self.tick_hint_s))
        if tick is None:
            return 0.0
        return eta_first_token(position, free_slots=self.pool.free_count,
                               wave_size=self.pool.num_slots, tick_s=tick,
                               tokens_per_tick=self._tpt_ewma or 1.0)

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        """Drive ``step()`` until no request is queued or running.  With
        ``heartbeat_timeout_s`` set, a Heartbeat watchdog guards every
        tick — a hung dispatch aborts cleanly instead of wedging the
        server, or, with ``recover_on_hang``, requests an arena reset +
        re-prefill at the next step boundary."""
        hb = Heartbeat(timeout=self.heartbeat_timeout_s,
                       on_failure=(self._hb_failure if self.recover_on_hang
                                   else self._on_failure)) \
            if self.heartbeat_timeout_s else None
        n = 0
        with hb if hb is not None else nullcontext():
            while self.pending:
                self.step()
                n += 1
                if hb is not None:
                    hb.beat(n)
                    if hb.fired and self.recover_on_hang:
                        # the monitor thread exits after firing once;
                        # re-arm it so a later hang is also caught
                        hb.stop()
                        hb.start()
                if max_steps is not None and n >= max_steps:
                    break
        if not self.pending:
            # a fully drained system is proof the last recovery took:
            # a fresh recovery budget, and no stale reset request
            self._recoveries = 0
            self._recover_flag.clear()

    def drain(self, max_steps: Optional[int] = None) -> None:
        """Stop accepting new requests and complete everything already
        in the system.  ``submit()`` raises :class:`EngineClosed` from
        the moment drain begins.  Safe to call repeatedly."""
        self._draining = True
        self.run_until_idle(max_steps=max_steps)

    def close(self) -> None:
        """``drain()`` to idle, then release the engine: the arena, the
        token vector and the captured graphs (with their pools) are
        dropped and every later ``submit()``/``step()`` raises
        :class:`EngineClosed`.  Idempotent."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        self.pool = None
        self._toks = self._chunk = self._spec_out = None
        self._hslot = self._hout = None
        self._prefill = self._decode = self._verify = self._handoff = None

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- internals ---------------------------------------------------------
    def _wire_spill(self) -> None:
        """Point the pool's spill-tier callbacks at this engine: spill/
        prefetch accounting lands in the metrics, and an injected
        ``serve.spill`` fault produces a flight dump + incident record
        (the fault only DEGRADES — the block dies or the prefix
        re-prefills, streams unchanged — but the evidence must exist)."""
        if self.pool.spill is None:
            return
        # looked up at each call: whatever metrics object the engine
        # holds then gets the counts
        self.pool.on_spill = lambda n: self.metrics.on_spill(n)
        self.pool.on_prefetch = lambda n, ms: self.metrics.on_prefetch(n, ms)
        self.pool.on_spill_fault = self._spill_fault

    def _spill_fault(self, op: str, exc: Exception) -> None:
        ref = self._flight_dump("serve.spill",
                                f"{op} fault: {type(exc).__name__}")
        self._incident("serve.spill", type(exc).__name__, f"op:{op}",
                       "degraded", 0, flight_ref=ref)

    #: dispatch site -> the program key the attribution ledger uses
    _ATTR_PROGRAMS = {"serve.prefill": "prefill_chunk",
                      "serve.decode": "decode",
                      "serve.verify": "verify"}

    def _attr_program(self, site: str) -> str:
        """The ledger key one dispatch accumulates under: an int8
        arena's decode is a program of its own (``decode_int8``)."""
        if site == "serve.decode" and self._kv_dtype == "int8":
            return "decode_int8"
        return self._ATTR_PROGRAMS.get(site, site)

    def _dispatch(self, site: str, fn, args, **attrs):
        """One guarded dispatch: the injection site fires first (on the
        host, BEFORE the program — the arena is still intact), and
        transient RuntimeError/OSError is retried with bounded
        exponential backoff.  A real failure inside a replay fails the
        retries too and escalates to the caller — quarantine for
        prefill, arena recovery for decode.

        With an attribution ledger installed (obs.attr), the SUCCESSFUL
        call is timed with the device synchronised around it (a replay
        returns before the card has run it); with no ledger the cost is
        one global read and no sync."""
        attempt = 0
        while True:
            try:
                faults.fire(site, attempt=attempt, **attrs)
                led = obs_attr.get()
                if led is None:
                    return fn(*args)
                _sync(self._device)
                t0 = time.perf_counter()
                out = fn(*args)
                _sync(self._device)
                led.note(self._attr_program(site),
                         time.perf_counter() - t0)
                return out
            except (RuntimeError, OSError) as e:
                if isinstance(e, failure.FailureDetected):
                    raise
                if attempt >= self.max_dispatch_retries:
                    raise
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** attempt))
                attempt += 1
                self.metrics.on_retry(site)
                self._sleep(delay)

    # -- paged-arena bookkeeping -------------------------------------------
    def _share_limit(self, req: Request) -> int:
        """How many leading blocks of this request's replay are ELIGIBLE
        for prefix sharing: full blocks wholly inside the ORIGINAL
        prompt, and never the whole replay — at least one suffix token
        must run prefill so the request has logits to pick from."""
        if not self.share_prefix:
            return 0
        bs = self.pool.block_size
        return min(req.prompt.size // bs,
                   (req.replay_ids().size - 1) // bs)

    def _blocks_needed(self, req: Request, n_shared: int) -> int:
        """Fresh blocks an admission must allocate: coverage for the
        replay plus the first decode position, minus the shared
        prefix."""
        replay = req.replay_ids().size
        return replay // self.pool.block_size + 1 - n_shared

    def _req_keys(self, req: Request) -> list:
        """The request's prefix chain keys, computed once (they depend
        only on the immutable prompt)."""
        if not self.share_prefix:
            return []
        if req.prefix_keys is None:
            req.prefix_keys = self.pool.prefix_keys(
                req.prompt, req.prompt.size // self.pool.block_size)
        return req.prefix_keys

    def _admittable(self, req: Request) -> bool:
        n_shared, n_lru = self.pool.probe_prefix(
            req.prompt, self._share_limit(req), keys=self._req_keys(req))
        # claiming shared blocks out of the evictable LRU consumes
        # available_blocks too
        return (self.pool.available_blocks - n_lru
                >= self._blocks_needed(req, n_shared))

    def _alloc_blocks(self, n: int, rid: int) -> Optional[List[int]]:
        """Claim ``n`` blocks through the ``serve.block_alloc`` injection
        site (fires BEFORE the host-side allocation).  None when the
        pool genuinely cannot cover ``n`` — the preemption cue."""
        faults.fire("serve.block_alloc", n=n, rid=rid)
        return self.pool.alloc_blocks(n)

    def _admit(self, req: Request) -> int:
        # the whole admission runs under the request's trace
        with obs_trace.activate(req.trace_id):
            return self._admit_traced(req)

    def _admit_traced(self, req: Request) -> int:
        slot = self.pool.alloc_slot()
        assert slot is not None, "admission with no free slot"
        # replay_ids == prompt for a fresh request; for a request
        # re-admitted by preemption or recovery it is prompt +
        # tokens-so-far, whose greedy prefill pick IS the next token
        replay = req.replay_ids()
        P = replay.size
        bs = self.pool.block_size
        first = not req.tokens
        owned: List[int] = []
        shared_ids: List[int] = []
        mapped = False
        # the allocation site fires once (no retry loop); only the
        # prefill dispatches go through _dispatch's backoff
        fail_site, fail_attempts = "serve.block_alloc", 1
        try:
            n_shared, shared_ids = self.pool.match_prefix(
                req.prompt, self._share_limit(req),
                keys=self._req_keys(req))
            owned = self._alloc_blocks(
                self._blocks_needed(req, n_shared), req.rid) or []
            if len(owned) < self._blocks_needed(req, n_shared):
                raise RuntimeError("block allocation came up short")
            fail_site = "serve.prefill"
            fail_attempts = self.max_dispatch_retries + 1
            self.pool.map_slot(slot, shared_ids + owned)
            mapped = True
            start0 = n_shared * bs
            if n_shared:
                self.metrics.on_prefix_hit(start0)
            with events.span("serve.prefill", slot=slot, prompt=P,
                             shared=start0):
                for start in range(start0, P, bs):
                    self._dispatch("serve.prefill", self._prefill_chunk,
                                   (replay[start:start + bs], start, slot),
                                   rid=req.rid)
                # the designed per-admission sync: one (num_slots,)
                # fetch delivers the prefill token
                tok = int(self._toks.cpu()[slot])
        except (RuntimeError, OSError) as e:
            if isinstance(e, failure.FailureDetected):
                raise
            # the failure fired before a dispatch touched anything
            # irreversible: unwind this request's claims and fail only
            # THIS request, not the engine
            if mapped:
                self.pool.release(slot)
            else:
                self.pool.unref_shared(shared_ids)
                self.pool.free_blocks(owned)
                self.pool.release_slot_row(slot)
            self._quarantine(req, e, fail_site, fail_attempts)
            return 0
        if self.share_prefix:
            self.pool.register_prefix(req.prompt, slot,
                                      req.prompt.size // bs,
                                      keys=self._req_keys(req))
        self.pool.activate(slot, P)
        req.slot = slot
        req.state = RUNNING
        self._running[slot] = req
        if first:
            self.metrics.on_admit()
        done = req.deliver(tok)       # prefill yields the (next) token
        self.metrics.on_deliver(req.rid, len(req.tokens))
        if first:
            self.metrics.on_first_token(req.ttft_s)
        if req.on_token is not None:
            req.on_token(tok, req.handle)
        if done:
            self._finalize(slot)
        return 1

    def _quarantine(self, req: Request, err: Exception,
                    site: str = "serve.prefill",
                    attempts: Optional[int] = None) -> None:
        """Repeatedly-poisoned prefill/admission: a per-request failure
        status (handle.failed / handle.error), never an engine crash."""
        if attempts is None:
            attempts = self.max_dispatch_retries + 1
        req.state = FAILED
        req.finish_reason = "quarantined"
        req.error = (f"{site} failed after {attempts} attempt(s): "
                     f"{type(err).__name__}: {err}")
        self.metrics.on_quarantine()
        ref = self._flight_dump(site, f"quarantine req:{req.rid}")
        self._incident(site, type(err).__name__,
                       f"req:{req.rid}", "quarantined", attempts,
                       flight_ref=ref)
        warnings.warn(f"serve: request {req.rid} quarantined: "
                      f"{req.error}", stacklevel=2)

    def _ensure_blocks(self) -> None:
        """Decode-time growth: every running slot whose next write
        position crosses into an unmapped block gets one more block —
        preempting the youngest running request when the pool is
        exhausted."""
        bs = self.pool.block_size
        for slot in sorted(self._running):
            req = self._running.get(slot)
            if req is None:
                continue
            # a verify round writes up to position pos + spec_k (the
            # full k+1 window), so a speculative slot needs its blocks
            # mapped spec_k positions ahead of a plain one
            need = (req.prompt.size + len(req.tokens) + self.spec_k) \
                // bs + 1
            while slot in self._running and \
                    self.pool.mapped_count(slot) < need:
                got = self._alloc_blocks(1, req.rid)
                if got:
                    self.pool.append_block(slot, got[0])
                else:
                    self._preempt_youngest()

    def _preempt_youngest(self) -> None:
        victim_slot = max(self._running,
                          key=lambda s: self._running[s].rid)
        req = self._running.pop(victim_slot)
        self.pool.release(victim_slot)
        req.state = QUEUED
        req.slot = None
        self.sched.requeue_front([req])
        with obs_trace.activate(req.trace_id):
            self.metrics.on_preempt()

    def _decode_tick(self) -> int:
        t0 = time.perf_counter()
        with events.span("serve.decode", active=len(self._running)):
            self._dispatch("serve.decode", self._decode, (),
                           active=len(self._running))
            # the designed per-tick sync: ONE (num_slots,) fetch
            toks = self._toks.cpu().numpy()
        dt = time.perf_counter() - t0
        delivered = 0
        for slot in list(self._running):
            req = self._running[slot]
            tok = int(toks[slot])
            with obs_trace.activate(req.trace_id):
                done = req.deliver(tok)
                self.metrics.on_token(dt)
                self.metrics.on_deliver(req.rid, len(req.tokens))
                self.metrics.on_slot_dispatch(1)
            if req.on_token is not None:
                req.on_token(tok, req.handle)
            delivered += 1
            if done:
                self._finalize(slot)
        self._note_tpt(delivered, delivered)
        return delivered

    def _spec_tick(self) -> int:
        """One speculative verify round (``spec.verify_round``), with a
        PLAIN-DECODE fallback when the verify DISPATCH dies past its
        retry budget (injected ``serve.verify`` faults included): one
        target-correct token per slot still lands this tick, the stream
        is unchanged (plain decode is the same target argmax), and only
        the draft cache takes a gap at the fallback position — a later
        accept-rate cost, never a correctness one.  Only
        :class:`~singa_tpu_torch.serve.spec.VerifyDispatchFailed` takes
        this path; a failure after the dispatch is half-committed and
        goes to step()'s arena recovery, as does a failing fallback."""
        participants = len(self._running)
        try:
            delivered = spec.verify_round(self)
        except spec.VerifyDispatchFailed as e:
            self.metrics.on_spec_fallback()
            warnings.warn(
                f"serve: verify round failed past retries "
                f"({type(e).__name__}: {e}); falling back to plain "
                f"decode for this tick", stacklevel=2)
            return self._decode_tick()
        self._note_tpt(delivered, participants)
        return delivered

    def _note_tpt(self, delivered: int, participants: int) -> None:
        """Fold one tick's accepted tokens per slot into the EWMA the
        shed eta reads (``eta_first_token``'s ``tokens_per_tick``)."""
        if not participants:
            return
        tpt = delivered / participants
        self._tpt_ewma = tpt if self._tpt_ewma is None else \
            0.8 * self._tpt_ewma + 0.2 * tpt

    def _finalize(self, slot: int, evicted: bool = False) -> None:
        req = self._running.pop(slot)
        self.pool.release(slot)
        req.state = EVICTED if evicted else FINISHED
        with obs_trace.activate(req.trace_id):
            self.metrics.on_evict(req.finish_reason or "unknown")

    # -- recovery ----------------------------------------------------------
    def recover(self, reason: str = "requested") -> None:
        """Reset the arena and re-prefill every in-flight request: the
        path behind Heartbeat hang detection, also callable directly
        after an external device event.  Each running request is
        requeued at the HEAD of the queue and re-prefilled from
        ``prompt + tokens-so-far``; greedy decode makes that replay
        idempotent, so the final streams are bit-identical to an
        uninterrupted run."""
        self._recover(reason)

    def _recover(self, reason: str) -> None:
        self._recoveries += 1
        if self._recoveries > self.max_recoveries:
            raise RuntimeError(
                f"serve engine exceeded max_recoveries="
                f"{self.max_recoveries} (last reason: {reason}) — the "
                f"fault is not transient; surfacing it instead of "
                f"rebuilding forever")
        with events.span("serve.recover", reason=reason):
            inflight = sorted(self._running.values(), key=lambda r: r.rid)
            self._running.clear()
            # the same storage reset in place (both arenas): the captured
            # programs read it by address, so recovery never recaptures.
            # The prefix cache dies with the arena's contents; the spill
            # store survives (chain keys commit to content)
            self.pool.reset()
            self._toks.zero_()
            requeue = []
            for req in inflight:
                if req.replay_ids().size >= self.pool.max_len:
                    # unreachable while submit() enforces prompt +
                    # budget <= max_len; a replay that could never
                    # decode again must fail loudly
                    req.state = FAILED
                    req.finish_reason = "unrecoverable"
                    req.error = (
                        f"cannot re-prefill after arena reset: prompt "
                        f"+ generated = {req.replay_ids().size} tokens "
                        f"leaves no room to decode under max_len "
                        f"({self.pool.max_len})")
                    with obs_trace.activate(req.trace_id):
                        self.metrics.on_evict("unrecoverable")
                        self._incident(
                            "serve.arena", reason, f"req:{req.rid}",
                            "unrecoverable", 0,
                            flight_ref=self._flight_dump(
                                "serve.arena",
                                f"unrecoverable req:{req.rid}"))
                else:
                    requeue.append(req)
            self.sched.requeue_front(requeue)
            self.metrics.on_recover(len(requeue))
            self._incident("serve.arena", reason,
                           f"inflight:{len(requeue)}", "recovered",
                           self._recoveries,
                           flight_ref=self._flight_dump(
                               "serve.arena", f"recovery: {reason}"))

    def _hb_failure(self, age: float, last_beat: int) -> None:
        """Heartbeat monitor-thread path (``recover_on_hang``): only
        REQUEST recovery — the step thread owns the arena and resets it
        at its next step boundary.  A user ``on_failure`` still gets the
        observation."""
        events.counter("serve.hangs", 1, age_s=round(age, 3))
        # monitor thread: deliberately trace-less
        self.flight.note("counter", "serve.hangs", age_s=round(age, 3))
        self._recover_flag.set()
        if self._on_failure is not None:
            self._on_failure(age, last_beat)

    # -- durable incident records + flight dumps --------------------------
    def _flight_dump(self, site: str, reason: str) -> Optional[str]:
        """Dump the flight ring next to the record store and return the
        ``flight_ref`` (or None without a store)."""
        return obs_flight.dump_for_store(self.flight, site,
                                         self.record_store, reason)

    def _incident(self, site: str, fault: str, ref, outcome: str,
                  retries: int, flight_ref: Optional[str] = None) -> None:
        """Append one ``incident`` entry to the run-record store (when
        ``record_store`` is set).  Best-effort: a full disk must not turn
        a survived fault into a crash.  Entries carry platform "cuda"
        (smoke False) or "cpu" (smoke True)."""
        events.counter("serve.incident", 1, site=site, outcome=outcome)
        self.flight.note("counter", "serve.incident", site=site,
                         outcome=outcome)
        if not self.record_store:
            return
        try:
            platform, kind = obs_record.device_kind(self._device)
            payload = {"site": site, "fault": fault, "ref": ref,
                       "outcome": outcome, "retries": int(retries),
                       "engine_run": self.run_id}
            if flight_ref:
                payload["flight_ref"] = flight_ref
            entry = obs_record.new_entry(
                "incident", platform, platform != "cuda", kind,
                run_id=f"{self.run_id}-inc{next(self._incident_seq)}",
                payload=payload)
            obs_record.RunRecord(self.record_store).append(entry)
        except Exception as e:
            warnings.warn(f"could not append incident record: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
