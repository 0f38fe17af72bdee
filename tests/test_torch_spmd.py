"""The port's sharding rules (singa_tpu_torch.parallel.spmd, the mesh
and tensor_parallel.shard_params) against the JAX package's
singa_tpu.parallel.spmd, in one process: the same names, shapes, dtypes
and mesh shapes give the same specs.  The reference's meshes are over
the conftest's eight virtual CPU devices; the port's are `Mesh` shapes
with no process group (the rules read only the shape).  Exact."""

import numpy as np
import pytest
import torch

from singa_tpu import layer as jlayer
from singa_tpu import models as jmodels
from singa_tpu import parallel as jparallel
from singa_tpu.parallel import spmd as jspmd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import parallel as tparallel
from singa_tpu_torch.parallel import spmd as tspmd
from singa_tpu_torch.parallel import tensor_parallel as tp
from singa_tpu_torch.parallel.mesh import Mesh, P

CPU = tdevice.create_device("cpu")

MESHES = [{"data": 8}, {"data": 2, "model": 4}, {"data": 2, "seq": 4},
          {"model": 2, "seq": 2}, {"data": 2, "model": 2, "seq": 2},
          {"dp": 2, "seq": 2}, {"model": 8}]

RULE_SETS = {
    "llama": tmodels.llama.LLAMA_SHARD_RULES,
    "transformer": tmodels.transformer.TRANSFORMER_SHARD_RULES,
    "moe": tmodels.llama.LLAMA_SHARD_RULES + tlayer.MoE.SHARD_RULES,
}

# names and shapes the rules meet in the models (tiny and base widths),
# and some they must not match or must drop
PARAMS = [
    ("blocks.0.attn.q_proj.W", (64, 64)), ("blocks.0.attn.k_proj.W", (64, 32)),
    ("blocks.3.attn.v_proj.W", (2048, 1024)),
    ("blocks.0.attn.o_proj.W", (64, 64)), ("blocks.0.ffn.gate.W", (64, 128)),
    ("blocks.0.ffn.up.W", (64, 128)), ("blocks.0.ffn.down.W", (128, 64)),
    ("tok_emb.table", (256, 64)), ("lm_head.W", (64, 256)),
    ("lm_head.W", (64, 250)), ("blocks.0.attn_norm.gamma", (64,)),
    ("blocks.0.attn.q_proj.b", (64,)), ("blocks.1.mlp.c_fc.W", (64, 256)),
    ("blocks.1.mlp.c_fc.b", (256,)), ("blocks.1.mlp.c_proj.W", (256, 64)),
    ("blocks.1.mlp.c_proj.b", (64,)), ("blocks.1.attn.out_proj.W", (64, 64)),
    ("wte.table", (256, 64)), ("wpe.table", (64, 64)),
    ("wtype.table", (2, 64)), ("blocks.0.ffn.w_in", (4, 64, 128)),
    ("blocks.0.ffn.router", (64, 4)), ("blocks.0.attn.q_proj.W", (64, 6)),
    ("blocks.0.attn.q_proj.W", (64, 4)),
]


def _jmesh(axes):
    return jparallel.make_mesh(axes)


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("rules", list(RULE_SETS))
def test_spec_for_equals_the_reference(axes, rules):
    jm, tm = _jmesh(axes), Mesh(axes)
    for name, shape in PARAMS:
        want = tuple(jspmd.spec_for(name, shape, RULE_SETS[rules], jm))
        got = tspmd.spec_for(name, shape, RULE_SETS[rules], tm)
        assert isinstance(got, P)
        assert tuple(got) == want, (name, shape)
    assert tspmd.spec_for("x.W", (8, 8), None, tm) == P()


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_batch_spec_equals_the_reference(axes):
    jm, tm = _jmesh(axes), Mesh(axes)
    data = "dp" if "dp" in axes else "data"
    for shape in ((8, 16), (7, 16), (8, 15), (8, 16, 4), (8,), (4, 32)):
        for np_dt, t_dt in ((np.int32, torch.int32), (np.int64, torch.long),
                            (np.float32, torch.float32)):
            want = tuple(jspmd.batch_spec(shape, np_dt, jm, data))
            assert tuple(tspmd.batch_spec(shape, np_dt, tm, data)) == want
            assert tuple(tspmd.batch_spec(shape, t_dt, tm, data)) == want


def _slot_trees(kind):
    """{name: slot tree} of SGD-momentum (a tensor), Adam (a tuple),
    Adafactor-like (a dict of factored leaves) and stateless (None)
    slots over parameters of the tiny widths."""
    shapes = {"blocks.0.attn.q_proj.W": (64, 64), "lm_head.W": (64, 256),
              "blocks.0.attn_norm.gamma": (64,), "tok_emb.table": (256, 64),
              "blocks.0.ffn.down.W": (128, 64), "odd.W": (6, 10)}
    z = np.zeros
    if kind == "sgd":
        return shapes, {n: z(s) for n, s in shapes.items()}
    if kind == "adam":
        return shapes, {n: (z(s), z(s)) for n, s in shapes.items()}
    if kind == "factored":
        return shapes, {n: {"vr": z(s[:1]), "vc": z(s[1:]) if len(s) > 1
                            else z(s), "m": z(s)} for n, s in shapes.items()}
    return shapes, {n: None for n in shapes}


def _specs(tree):
    """Specs of a shardings tree as plain tuples (None leaves kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs(v) for v in tree)
    return tuple(tree.spec)


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adam", "factored", "none"])
@pytest.mark.parametrize("axes", [{"data": 8}, {"data": 2, "model": 4},
                                  {"data": 4, "model": 2},
                                  {"data": 2, "model": 2, "seq": 2}],
                         ids=lambda a: "x".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_tree_shardings_equal_the_reference(axes, kind, zero1):
    import jax.numpy as jnp
    jm, tm = _jmesh(axes), Mesh(axes)
    shapes, tree = _slot_trees(kind)
    rules = tmodels.llama.LLAMA_SHARD_RULES
    jparams = {n: jnp.zeros(s) for n, s in shapes.items()}
    tparams = {n: torch.zeros(s) for n, s in shapes.items()}
    jsh = jspmd.param_shardings(jparams, rules, jm)
    tsh = tspmd.param_shardings(tparams, rules, tm)
    assert {n: tuple(s.spec) for n, s in tsh.items()} == \
        {n: tuple(s.spec) for n, s in jsh.items()}
    axis = "data" if zero1 else None
    jtree = {n: (None if v is None else
                 jnp.zeros(v.shape) if isinstance(v, np.ndarray) else
                 type(v)(jnp.zeros(x.shape) for x in v)
                 if isinstance(v, tuple) else
                 {k: jnp.zeros(x.shape) for k, x in v.items()})
             for n, v in tree.items()}
    ttree = {n: (None if v is None else
                 torch.zeros(v.shape) if isinstance(v, np.ndarray) else
                 type(v)(torch.zeros(x.shape) for x in v)
                 if isinstance(v, tuple) else
                 {k: torch.zeros(x.shape) for k, x in v.items()})
             for n, v in tree.items()}
    want = jspmd.tree_shardings(jtree, jsh, jm, shapes, zero1_axis=axis)
    got = tspmd.tree_shardings(ttree, tsh, tm, shapes, zero1_axis=axis)
    assert _specs(got) == _specs(want)


def _rules(rules):
    return [(pat, tuple(spec)) for pat, spec in rules or []]


@pytest.mark.parametrize("which", ["llama", "llama_moe", "gpt2", "bert",
                                   "mlp", "moe_layer_model"])
def test_collect_shard_rules_equals_the_reference(which):
    tiny = {"num_layers": 1}
    if which.startswith("llama"):
        extra = dict(num_experts=4) if which == "llama_moe" else {}
        jm = jmodels.Llama(jmodels.LlamaConfig(
            **{**vars(jmodels.LlamaConfig.tiny()), **tiny, **extra}))
        tm = tmodels.Llama(tmodels.LlamaConfig(
            **{**vars(tmodels.LlamaConfig.tiny()), **tiny, **extra}),
            device=CPU)
    elif which == "gpt2":
        jm = jmodels.GPT2(jmodels.GPT2Config.tiny())
        tm = tmodels.GPT2(tmodels.GPT2Config.tiny(), device=CPU)
    elif which == "bert":
        jm = jmodels.BERT(jmodels.BERTConfig.tiny(num_labels=2))
        tm = tmodels.BERT(tmodels.BERTConfig.tiny(num_labels=2), device=CPU)
    elif which == "mlp":
        jm = jmodels.MLP(perceptron_size=(8,), num_classes=2)
        tm = tmodels.MLP(perceptron_size=(8,), num_classes=2,
                         input_shape=(4,), device=CPU)
    else:
        class JM(jmodels.MLP):
            def __init__(self):
                super().__init__(perceptron_size=(8,), num_classes=2)
                self.moe = jlayer.MoE(4, ffn_dim=8)

        class TM(tmodels.MLP):
            def __init__(self):
                super().__init__(perceptron_size=(8,), num_classes=2,
                                 input_shape=(4,), device=CPU)
                self.moe = tlayer.MoE(4, ffn_dim=8, dim=4, device=CPU)
        jm, tm = JM(), TM()
    assert _rules(tspmd.collect_shard_rules(tm)) == \
        _rules(jspmd.collect_shard_rules(jm))


def test_zero1_axis_for_keeps_the_port_world_of_one():
    """The reference's rule, but a data axis of one rank is eligible (a
    host with one card runs ZeRO-1's collectives)."""
    o = topt.DistOpt(topt.SGD(lr=0.1), shard_weight_update=True)
    assert tspmd.zero1_axis_for(o, Mesh({"data": 2, "model": 2})) == "data"
    assert tspmd.zero1_axis_for(o, Mesh({"data": 1})) == "data"
    assert tspmd.zero1_axis_for(o, Mesh({"model": 2})) is None
    assert tspmd.zero1_axis_for(topt.DistOpt(topt.SGD(lr=0.1)),
                                Mesh({"data": 2})) is None
    with pytest.warns(UserWarning, match="ignored"):
        assert tspmd.zero1_axis_for(
            topt.DistOpt(topt.SGD(lr=0.1), shard_weight_update=True,
                         compression="int8_ring"), Mesh({"data": 2})) is None


def test_trace_rules_round_trip():
    assert tspmd.current_trace_rules() is None
    tspmd.set_trace_rules([("a", ("model",))])
    try:
        assert tspmd.current_trace_rules() == [("a", ("model",))]
    finally:
        tspmd.set_trace_rules(None)


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2, "seq": 2},
                                  {"data": 4, "model": 2}, {"seq": 8}],
                         ids=lambda a: "x".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_rank_coordinates_follow_the_reference_device_layout(axes):
    """Rank r sits where the reference's reshape of the device list puts
    device r; a line along an axis set is the ranks that differ only in
    it, in axis order."""
    jm, tm = _jmesh(axes), Mesh(axes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(ids, tm.devices)
    for r in range(tm.size):
        c = tm.coords(r)
        assert ids[tuple(c[a] for a in tm.axis_names)] == r
        for a in tm.axis_names:
            line = tm.line(a, r)
            assert len(line) == axes[a] and line[c[a]] == r
            assert all(tm.coords(x)[b] == c[b] for x in line
                       for b in tm.axis_names if b != a)
            assert tm.axis_index(a, r) == c[a]
        rest = tuple(a for a in tm.axis_names if a != "model")
        assert tm.axis_index(rest, r) == tm.line(rest, r).index(r)


def test_mesh_axes_and_data_axis():
    assert tparallel.make_mesh({"data": 1, "model": 1, "seq": 1}).shape == \
        {"data": 1, "model": 1, "seq": 1}
    # the pipe and expert axes exist since the pipeline/expert slice
    for axes in ({"data": 1, "pipe": 1}, {"expert": 1}):
        assert tparallel.make_mesh(axes).shape == axes
    with pytest.raises(ValueError, match="needs 2 devices"):
        tparallel.make_mesh({"data": 1, "model": 2})
    tparallel.set_mesh(tparallel.make_mesh({"dp": 1, "seq": 1}))
    try:
        tparallel.mesh.set_data_axis("dp")
        assert tparallel.mesh.current_data_axis() == "dp"
        with pytest.raises(ValueError, match="not an axis"):
            tparallel.mesh.set_data_axis("data")
    finally:
        tparallel.mesh._data_axis = "data"
        tparallel.set_mesh(None)
    assert tparallel.mesh.named_sharding("data") is None
    m = tparallel.make_mesh({"data": 1})
    tparallel.set_mesh(m)
    try:
        sh = tparallel.mesh.named_sharding(None, "model")
        assert sh.mesh is m and sh.spec == P(None, "model")
        assert repr(sh.spec) == "P(None, 'model')"
    finally:
        tparallel.set_mesh(None)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_shard_params_cuts_attention_by_whole_heads(model):
    """shard_params records the reference's spec on every parameter but
    where the model axis would cut an attention head (tiny Llama's two
    kv heads at model = 4 and 8; its four q heads at 8): there the
    projection stays whole.  Each rank's block is its slice of the
    full parameter."""
    axes = {"data": 8 // model, "model": model} if model < 8 \
        else {"model": 8}
    full = tmodels.Llama(tmodels.LlamaConfig.tiny(), device=CPU,
                         generator=torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in full.get_params().items()}
    jm = _jmesh(axes)
    want = {n: tuple(jspmd.spec_for(n, p.shape, tmodels.Llama.SHARD_RULES,
                                    jm)) for n, p in start.items()}
    mesh = Mesh(axes)
    specs = tp.shard_params(full, tspmd.collect_shard_rules(full), mesh)
    hd = tmodels.LlamaConfig.tiny().head_dim
    for n, spec in specs.items():
        p = full.get_params()[n]
        assert p.tp_spec == spec and p.tp_full_shape == start[n].shape
        heads = (n.endswith(("q_proj.W", "k_proj.W", "v_proj.W"))
                 and start[n].shape[1] % (model * hd))
        rows = n.endswith("o_proj.W") and start[n].shape[0] % (model * hd)
        assert tuple(spec) == (() if heads or rows else want[n]), n
        d = tp.sharded_dim(p)
        if d is None:
            assert torch.equal(p, start[n])
        else:
            assert p.shape[d] == start[n].shape[d] // model
            assert torch.equal(p, start[n].narrow(d, 0, p.shape[d]))
            assert torch.equal(tp.local_block(p, start[n].numpy()), p)
