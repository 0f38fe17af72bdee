"""Structural ONNX model validation, a verbatim copy of
``singa_tpu/sonnx/checker.py`` below this docstring: a pure-python
subset of ``onnx.checker.check_model`` that needs no ``onnx`` wheel.

Validates the rules the official checker enforces for the graphs this
framework produces and consumes:

  * model: ir_version set, at least one opset_import, graph present;
  * graph SSA: every node input resolves to a graph input, an
    initializer, or an EARLIER node's output; no value name is defined
    twice; every graph output is defined;
  * nodes: non-empty op_type; empty-string inputs allowed (ONNX's
    "optional absent" convention);
  * initializers: known dtype, raw_data length == prod(dims) *
    itemsize when raw encoding is used (a BFLOAT16 tensor sizes as its
    uint16 bits, ``proto._TP2NP``);
  * attributes: a name, and a consistent type/value pairing (at most
    one value family populated; declared type matches it when set);
    sub-graph attributes (If/Loop) are checked recursively with outer
    scope visible (ONNX scoping rule).
"""

from __future__ import annotations

from math import prod

from .proto import (AttributeProto, GraphProto, ModelProto, TensorProto,
                    _TP2NP)

__all__ = ["CheckError", "check_model", "check_graph"]


class CheckError(ValueError):
    """A structural validation failure (mirrors onnx.checker's
    ValidationError role)."""


def _fail(msg: str) -> None:
    raise CheckError(msg)


# attribute value families: (field, AttributeProto type enum, is_repeated)
_ATTR_FAMILIES = (
    ("f", AttributeProto.FLOAT, False),
    ("i", AttributeProto.INT, False),
    ("s", AttributeProto.STRING, False),
    ("t", AttributeProto.TENSOR, False),
    ("g", AttributeProto.GRAPH, False),
    ("floats", AttributeProto.FLOATS, True),
    ("ints", AttributeProto.INTS, True),
    ("strings", AttributeProto.STRINGS, True),
    ("tensors", AttributeProto.TENSORS, True),
    ("graphs", AttributeProto.GRAPHS, True),
)


def _check_attribute(a: AttributeProto, node_name: str,
                     outer_scope: set) -> None:
    if not a.name:
        _fail(f"node {node_name!r}: attribute without a name")
    populated = []
    for field, enum, rep in _ATTR_FAMILIES:
        v = getattr(a, field, None)
        if rep:
            if v:
                populated.append((field, enum))
        else:
            # scalar fields: proto3 default (0 / empty) is
            # indistinguishable from set — rely on the declared type
            # when present, else detect non-default
            if field in ("t", "g"):
                if v is not None:
                    populated.append((field, enum))
            elif v:
                populated.append((field, enum))
    declared = a.type or 0
    if len(populated) > 1:
        # the official checker rejects multi-family attributes whether
        # or not a type is declared — a declared type matching ONE of
        # the families must not launder the extra payload through
        _fail(f"node {node_name!r}: attribute {a.name!r} has multiple "
              f"value families {populated}"
              + (f" (declared type {declared})" if declared
                 else " and no type"))
    if declared:
        matches = [e for _f, e in populated]
        if populated and declared not in matches:
            # scalar zero values legitimately vanish; only complain
            # when a DIFFERENT family is populated
            _fail(f"node {node_name!r}: attribute {a.name!r} declares "
                  f"type {declared} but carries {populated}")
    # recurse into sub-graphs with the outer scope visible
    if a.g is not None:
        check_graph(a.g, outer_scope=outer_scope)
    for g in a.graphs or ():
        check_graph(g, outer_scope=outer_scope)


def _check_initializer(t: TensorProto, graph_name: str) -> None:
    if not t.name:
        _fail(f"graph {graph_name!r}: initializer without a name")
    dt = t.data_type or TensorProto.FLOAT
    np_dt = _TP2NP.get(dt)
    if np_dt is None:
        _fail(f"initializer {t.name!r}: unknown data_type {dt}")
    n = prod(t.dims) if t.dims else 1
    if t.raw_data:
        expect = n * np_dt.itemsize
        if len(t.raw_data) != expect:
            _fail(f"initializer {t.name!r}: raw_data is "
                  f"{len(t.raw_data)} bytes, dims {list(t.dims)} x "
                  f"{np_dt} needs {expect}")
    else:
        typed = (t.float_data or t.int32_data or t.int64_data
                 or t.double_data or t.uint64_data or t.string_data)
        if typed and len(typed) not in (n, 0):
            _fail(f"initializer {t.name!r}: {len(typed)} typed values "
                  f"for dims {list(t.dims)}")


def check_graph(g: GraphProto, outer_scope: set | None = None) -> None:
    name = g.name or "<unnamed>"
    defined = set(outer_scope or ())
    for vi in g.input or ():
        if not vi.name:
            _fail(f"graph {name!r}: graph input without a name")
        defined.add(vi.name)
    for init in g.initializer or ():
        _check_initializer(init, name)
        defined.add(init.name)
    for i, node in enumerate(g.node or ()):
        label = node.name or f"#{i}({node.op_type})"
        if not node.op_type:
            _fail(f"graph {name!r}: node {label!r} has no op_type")
        for inp in node.input or ():
            if inp and inp not in defined:
                _fail(f"graph {name!r}: node {label!r} input {inp!r} is "
                      f"not a graph input, initializer, or earlier "
                      f"node output (SSA violation)")
        for a in node.attribute or ():
            _check_attribute(a, label, defined)
        for out in node.output or ():
            if not out:
                continue
            if out in defined:
                _fail(f"graph {name!r}: value {out!r} defined twice "
                      f"(SSA violation at node {label!r})")
            defined.add(out)
    for vo in g.output or ():
        if vo.name and vo.name not in defined:
            _fail(f"graph {name!r}: graph output {vo.name!r} is never "
                  f"produced")


def check_model(m: ModelProto) -> None:
    """Validate `m` structurally; raises CheckError on the first
    violation, returns None when the model passes (the official
    checker's contract)."""
    if not m.ir_version:
        _fail("model has no ir_version")
    if not m.opset_import:
        _fail("model has no opset_import")
    for op in m.opset_import:
        if op.version in (None, 0):
            _fail(f"opset_import for domain {op.domain!r} has no version")
    if m.graph is None:
        _fail("model has no graph")
    check_graph(m.graph)
