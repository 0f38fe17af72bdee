"""The port's KV memory hierarchy (singa_tpu_torch/serve/mem.py and the
int8 branches of ops/kv_cache.py) against the JAX package's, on the CPU:
LlamaConfig.tiny() in f32 with the reference's weights carried over
through `load_reference_params`, at the reference tests' shapes.

The int8 quantize/gather/scatter ops must equal the reference's exactly;
the int8 engine's and the spill engine's streams must equal the
reference engine's; the spill store behaves as the reference's; a
spilled and restored block round-trips bitwise through one restore
program; the store survives recovery; and an injected serve.spill fault
degrades to re-prefill on the same calls as the reference's."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import faults as jfaults
from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.ops import kv_cache as jkv
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu.serve import mem as jmem
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.ops import kv_cache as tkv
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.serve import mem as tmem

SLOTS, MAX_LEN, BS = 4, 32, 8


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights)."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return jm, tm


def _prompts(lens, seed=7, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _tokens(hs):
    return [list(map(int, h.tokens)) for h in hs]


# -- quantize / dequantize ----------------------------------------------------

def _quant_input(case):
    rng = np.random.RandomState(0)
    if case == "scaled":
        return rng.randn(5, 8, 2, 16).astype(np.float32) * \
            rng.uniform(0.01, 100.0, (5, 8, 1, 1)).astype(np.float32)
    if case == "zero_slab":
        x = rng.randn(3, 8, 2, 16).astype(np.float32)
        x[1, 4] = 0.0
        return x
    if case == "extrema":
        x = np.zeros((1, 2, 2, 4), np.float32)
        x[0, 0, 0, 0], x[0, 0, 1, 2] = 3.0, -3.0
        x[0, 1] = rng.randn(2, 4) * 1e-4
        return x
    # half-way codes: values at k + 0.5 steps exercise round-half-even
    x = (np.arange(2 * 8 * 2 * 4, dtype=np.float32).reshape(2, 8, 2, 4)
         % 9 - 4) + 0.5
    x[..., 0, 0] = 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["scaled", "zero_slab", "extrema",
                                  "half_steps"])
def test_quantize_kv_equals_the_reference_exactly(case, dtype):
    x = _quant_input(case)
    jq, js = jkv.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq, ts).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js)))
    if case == "zero_slab":
        assert (tq[1, 4] == 0).all()
        assert (tkv.dequantize_kv(tq, ts)[1, 4] == 0).all()
    if case == "extrema":
        assert tq[0, 0, 0, 0] == 127 and tq[0, 0, 1, 2] == -127


def _quant_arena(seed, nb=6, k=2, d=4):
    """A QuantKV (k, v) pair with seeded codes and scales, as numpy."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(-127, 128, (nb, BS, k, d)).astype(np.int8),
             rng.uniform(0.01, 2.0, (nb, BS, 1, 1)).astype(np.float32))
            for _ in range(2)]


def _to_j(arena):
    return [jkv.QuantKV(jnp.asarray(q), jnp.asarray(s)) for q, s in arena]


def _to_t(arena):
    return [tkv.QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
            for q, s in arena]


def _int8_case(op, seed=0):
    """(reference outputs, port outputs) of one int8 op on seeded
    arenas: the gathered dense views, or the written codes and scales."""
    arena = _quant_arena(seed)
    jk, jv = _to_j(arena)
    tk, tv = _to_t(arena)
    rng = np.random.RandomState(seed + 1)
    if op == "gather":
        table = rng.randint(0, 6, (3, 4)).astype(np.int32)
        return (jkv.gather_block_kv(jk, jv, jnp.asarray(table)),
                tkv.gather_block_kv(tk, tv, torch.from_numpy(table)))
    if op == "scatter_block":
        kb, vb = rng.randn(2, BS, 2, 4).astype(np.float32)
        ref = jkv.scatter_block_kv(jk, jv, jnp.asarray(3, jnp.int32),
                                   jnp.asarray(kb), jnp.asarray(vb))
        out = tkv.scatter_block_kv(tk, tv, torch.tensor(3),
                                   torch.from_numpy(kb), torch.from_numpy(vb))
    elif op == "scatter_token":
        block, off = np.array([2, 5, 1], np.int32), np.array([0, 7, 3],
                                                              np.int32)
        kt, vt = rng.randn(2, 3, 2, 4).astype(np.float32)
        ref = jkv.scatter_token_kv(jk, jv, jnp.asarray(block),
                                   jnp.asarray(off), jnp.asarray(kt),
                                   jnp.asarray(vt))
        out = tkv.scatter_token_kv(tk, tv, torch.from_numpy(block),
                                   torch.from_numpy(off),
                                   torch.from_numpy(kt), torch.from_numpy(vt))
    else:
        blocks = np.array([[2, 2, 3], [5, 5, 5]], np.int32)
        offs = np.array([[6, 7, 0], [1, 2, 3]], np.int32)
        kt, vt = rng.randn(2, 2, 3, 2, 4).astype(np.float32)
        ref = jkv.scatter_tokens_kv(jk, jv, jnp.asarray(blocks),
                                    jnp.asarray(offs), jnp.asarray(kt),
                                    jnp.asarray(vt))
        out = tkv.scatter_tokens_kv(tk, tv, torch.from_numpy(blocks),
                                    torch.from_numpy(offs),
                                    torch.from_numpy(kt),
                                    torch.from_numpy(vt))
    assert out[0] is tk and out[1] is tv            # written in place
    return ([a for c in ref for a in (c.q, c.scale)],
            [a for c in out for a in (c.q, c.scale)])


@pytest.mark.parametrize("op", ["gather", "scatter_block", "scatter_token",
                                "scatter_tokens"])
def test_int8_paged_ops_equal_the_reference_exactly(op):
    ref, out = _int8_case(op)
    for r, o in zip(ref, out, strict=True):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_full_precision_scatter_tokens_equals_the_reference():
    rng = np.random.RandomState(4)
    ck, cv = rng.randn(2, 6, BS, 2, 4).astype(np.float32)
    blocks = np.array([[1, 1], [4, 0]], np.int32)
    offs = np.array([[3, 4], [7, 0]], np.int32)
    kt, vt = rng.randn(2, 2, 2, 2, 4).astype(np.float32)
    ref = jkv.scatter_tokens_kv(jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(blocks), jnp.asarray(offs),
                                jnp.asarray(kt), jnp.asarray(vt))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out = tkv.scatter_tokens_kv(tk, tv, torch.from_numpy(blocks),
                                torch.from_numpy(offs), torch.from_numpy(kt),
                                torch.from_numpy(vt))
    assert out[0] is tk
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# -- arena construction and bytes ----------------------------------------------

@pytest.mark.parametrize("spelling", [None, "f32", "full", "int8", "int4",
                                      "INT8", "bf16"])
def test_kv_dtype_spellings_match_the_reference(spelling):
    try:
        want = jmem.normalize_kv_dtype(spelling)
    except ValueError:
        with pytest.raises(ValueError, match="kv_dtype"):
            tmem.normalize_kv_dtype(spelling)
        return
    assert tmem.normalize_kv_dtype(spelling) == want


@pytest.mark.parametrize("target", [None, "int8"])
@pytest.mark.parametrize("draft", [False, True])
def test_arena_bytes_match_the_reference(pair, target, draft):
    jm, tm = pair

    def arena(mod, m, kind):
        if kind == "int8":
            return mod.quant_arena(m, 6, BS)
        return m.init_caches(6, BS)

    jd = arena(jmem, jm, "int8") if draft else None
    td = arena(tmem, tm, "int8") if draft else None
    jc, tc = arena(jmem, jm, target), arena(tmem, tm, target)
    assert tmem.arena_block_bytes(tc, td) == jmem.arena_block_bytes(jc, jd)
    assert tmem.arena_bytes(tc, td) == jmem.arena_bytes(jc, jd)
    if target == "int8":
        assert tc[0][0].q.dtype == torch.int8
        assert tuple(tc[0][0].scale.shape) == tuple(jc[0][0].scale.shape)


def test_int8_engine_streams_equal_the_reference_engine(pair):
    jm, tm = pair
    prompts = _prompts([4, 9, 13, 6])
    streams = []
    for eng in (JEngine(jm, SLOTS, MAX_LEN, block_size=BS, kv_dtype="int8"),
                ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS,
                            kv_dtype="int8")):
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.step()
        in_use = eng.pool.blocks_in_use
        assert in_use > 0
        assert eng.pool.blocks_in_use_bytes == in_use * eng.pool.block_bytes
        eng.run_until_idle()
        streams.append(_tokens(hs))
        counts = eng.compiled_counts()
    assert streams[1] == streams[0]
    assert counts == (1, 1)


# -- the spill store (host side) -----------------------------------------------

def _payload(seed, n=64):
    rng = np.random.RandomState(seed)
    return {"kv": [(torch.from_numpy(rng.randn(n).astype(np.float32)),)],
            "draft": None, "event": None}


def _jpayload(seed, n=64):
    rng = np.random.RandomState(seed)
    return {"kv": (rng.randn(n).astype(np.float32),), "draft": None}


@pytest.mark.parametrize("script", ["capacity", "get_refreshes", "pop",
                                    "bytes"])
def test_spill_store_behaves_as_the_reference(script):
    stores = [(jmem.SpillStore(max_blocks=2), _jpayload),
              (tmem.SpillStore(max_blocks=2), _payload)]
    seen = []
    for s, payload in stores:
        s.put(b"a", payload(0))
        s.put(b"b", payload(1, n=32))
        if script == "get_refreshes":
            s.get(b"a")
        if script == "pop":
            got = s.pop(b"a") is not None, s.pop(b"a") is None, \
                s.get(b"a") is None
        else:
            got = ()
        if script != "bytes":
            s.put(b"c", payload(2))
        s.settle()
        seen.append((len(s), s.evictions, s.bytes,
                     [k in s for k in (b"a", b"b", b"c")], got))
    assert seen[1] == seen[0]


def test_spill_store_refuses_zero_capacity():
    with pytest.raises(ValueError, match="spill capacity"):
        tmem.SpillStore(max_blocks=0)


# -- the spill tier through the engine -----------------------------------------

def _shared_workload(vocab=256, prefix=16, seed=17):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, (prefix,)).astype(np.int32)
    tails = [rng.randint(0, vocab, (4,)).astype(np.int32) for _ in range(2)]
    churn = [rng.randint(0, vocab, (20,)).astype(np.int32) for _ in range(4)]
    return [np.concatenate([shared, t]) for t in tails], churn


def _spill_run(eng, seed=17, recover=False, plan=None, fmod=None):
    """One shared-prefix request, four churning ones that evict (and so
    spill) its blocks, then a second request on the same prefix."""
    prompts, churn = _shared_workload(seed=seed)
    ctx = fmod.active(plan) if plan is not None else None
    with ctx if ctx is not None else warnings.catch_warnings():
        hs = [eng.submit(prompts[0], max_new_tokens=6)]
        eng.run_until_idle()
        hs += [eng.submit(q, max_new_tokens=4) for q in churn]
        eng.run_until_idle()
        spilled = eng.metrics.spilled_blocks
        if recover:
            eng.recover("test")
        hs.append(eng.submit(prompts[1], max_new_tokens=6))
        eng.run_until_idle()
    return _tokens(hs), spilled, eng.metrics.snapshot()


def _spill_engines(pair, **kw):
    jm, tm = pair
    kw = dict(num_slots=2, max_len=MAX_LEN, block_size=BS, num_blocks=9,
              spill_blocks=16, **kw)
    return JEngine(jm, **kw), ServeEngine(tm, **kw)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spill_restore_streams_equal_the_reference_with_one_program(
        pair, kv_dtype):
    je, te = _spill_engines(pair, kv_dtype=kv_dtype)
    (jt, _, js), (tt, _, ts) = _spill_run(je), _spill_run(te)
    assert tt == jt
    assert ts["spilled_blocks"] == js["spilled_blocks"] > 0
    assert ts["prefetch_hits"] == js["prefetch_hits"] > 0
    assert te.compiled_counts() == (1, 1)
    assert tmem.restore_compiled_count(te.pool.restore) == 1
    assert tmem.restore_compiled_count() == 1
    if kv_dtype is None:
        # a restore is a copy: the same streams as without the tier
        plain = ServeEngine(pair[1], num_slots=2, max_len=MAX_LEN,
                            block_size=BS, num_blocks=9)
        assert _spill_run(plain)[0] == tt


def test_spilled_block_round_trips_bitwise(pair):
    _, tm = pair
    eng = ServeEngine(tm, num_slots=2, max_len=MAX_LEN, block_size=BS,
                      kv_dtype="int8")
    eng.submit(_prompts([12])[0], max_new_tokens=4)
    eng.run_until_idle()
    pool = eng.pool
    before = tmem.read_block(pool.caches, None, 1)
    kept = [t.clone() for t in tmem._leaves(before["kv"])]
    restore = tmem.Restore(pool.caches, None)
    for t in tmem._leaves(pool.caches):
        t[1].zero_()                    # the payload is not a view
    assert all(torch.equal(a, b) for a, b in
               zip(kept, tmem._leaves(before["kv"])))
    tmem.write_block(restore, 1, before)
    after = tmem.read_block(pool.caches, None, 1)
    for a, b in zip(kept, tmem._leaves(after["kv"]), strict=True):
        assert torch.equal(a, b)


def test_spill_store_survives_recovery(pair):
    je, te = _spill_engines(pair)
    (jt, jn, js), (tt, tn, ts) = (_spill_run(e, seed=23, recover=True)
                                  for e in (je, te))
    assert tt == jt and tn == jn > 0
    assert ts["recoveries"] == js["recoveries"] == 1
    assert ts["prefetch_hits"] == js["prefetch_hits"] > 0
    assert tmem.restore_compiled_count(te.pool.restore) == 1


@pytest.mark.parametrize("op", ["spill", "prefetch"])
def test_injected_spill_fault_degrades_as_the_reference(pair, op):
    """An injected serve.spill fault skips every spill (the blocks die)
    or the first restore (the prefix re-prefills): the streams stay
    those of a fault-free run, and the port fires on the same calls."""
    clean, spilled, _ = _spill_run(_spill_engines(pair)[1])
    # the spill seam fires once per spilled block, then the re-hit's
    # first restore is the next call
    trigger = {} if op == "spill" else dict(at=spilled + 1)
    runs = []
    for eng, fmod in zip(_spill_engines(pair), (jfaults, tfaults)):
        plan = fmod.FaultPlan([fmod.FaultSpec("serve.spill", "error",
                                              **trigger)], seed=1)
        runs.append((_spill_run(eng, plan=plan, fmod=fmod), plan))
    (jrun, jplan), (trun, tplan) = runs
    assert trun[0] == jrun[0] == clean
    assert tplan.fire_count() == jplan.fire_count() > 0
    assert tplan.calls == jplan.calls
    for key in ("spilled_blocks", "prefetch_hits"):
        assert trun[2][key] == jrun[2][key]
    assert trun[2]["prefetch_hits"] == 0
