"""The frozen arithmetic against numbers worked by hand, and the seeded
generators."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import flops, traffic, weights


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_window_and_causal_pairs():
    # Σ_{t<8192} min(t + 1, 4096) = 4096·4097/2 + 4096·4096
    assert flops.attention_pairs(8192, 4096) == 25_167_872
    assert flops.attention_pairs(2048) == 2048 * 2049 // 2 == 2_098_176
    assert flops.attention_pairs(1024, 4096) == flops.attention_pairs(1024)


def test_active_params_and_model_flops():
    mistral, mixtral = _cfg("mistral-7b"), _cfg("mixtral-8x7b")
    # a layer: q, o 4096²; k, v 4096·1024; three 4096·14336; two norms
    layer = 2 * 4096 ** 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336 + 2 * 4096
    assert layer == 218_112_000
    assert flops.active_params(mistral) == 32 * layer + 4096 + 4096 * 32000 \
        == 7_110_660_096
    assert flops.train_flops_per_token(mistral, 8192) \
        == 6 * 7_110_660_096 + 12 * 32 * 4096 * 4096 == 49_106_411_520
    # two of eight experts and the router a layer, four layers
    moe_layer = layer + 3 * 4096 * 14336 + 4096 * 8
    assert flops.active_params(mixtral) == 4 * moe_layer + 4096 \
        + 4096 * 32000 == 1_708_298_240
    assert flops.train_flops_per_token(mixtral, 2048) == 10_652_442_624


def test_bounds():
    f, b = flops.attention_fwd_bwd(1, 8192, 32, 8, 128, 4096)
    assert f == 14 * 25_167_872 * 32 * 128
    assert b == 2 * (4 * 8192 * 32 * 128 + 4 * 8192 * 8 * 128)
    t, by = flops.bound_s(f, b)
    assert by == "operations" and t == pytest.approx(1.4592e-3, rel=1e-4)
    f, b = flops.moe_fwd_bwd(2048, 2, 8, 4096, 14336)
    assert f == 18 * 2048 * 2 * 4096 * 14336
    t, by = flops.bound_s(f, b)
    assert by == "operations" and t == pytest.approx(4.3774e-3, rel=1e-4)
    with pytest.raises(ValueError):
        flops.pct(float("nan"))


@pytest.mark.parametrize("mix", ["tiny-chat", "serve-batch"])
def test_traffic_repeats_and_keeps_its_sizes(mix):
    from conftest import TINY_CHAT
    m = dict(TINY_CHAT) if mix == "tiny-chat" else json.loads(
        (BENCH / "mixes" / f"{mix}.json").read_text())
    m.setdefault("rate_rps", 4.0)
    m.update(warm_s=m.get("warm_s", 5), drain_s=m.get("drain_s", 5), pool=64)

    def draw(seed):
        if m["loop"] == "open":
            return traffic.open_loop(m, seed, 10.0, 32000)
        return traffic.closed_pool(m, seed, 32000)
    a, b, c = draw(2 ** 31 + 7), draw(2 ** 31 + 7), draw(5)
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    sizes = sorted((x.prompt.size, x.max_new) for x in a)
    assert sizes == sorted((x.prompt.size, x.max_new) for x in c)
    assert [x.prompt.size for x in a] != [x.prompt.size for x in c]
    for x in a:
        assert x.prompt.size + x.max_new <= m["max_len"]
    if m["loop"] == "open":
        win = [x for x in a if x.phase == "window"]
        assert len(win) == round(m["rate_rps"] * 10.0)
        assert all(0.0 <= x.due_s < 10.0 for x in win)
        sys_len = m["system_len"]
        heads = {x.prompt[:sys_len].tobytes() for x in a}
        assert len(heads) <= m["tenants"]


def test_weights_repeat_leaf_by_leaf():
    cfg = json.loads((BENCH / "configs" / "mixtral-8x7b.json").read_text())
    cfg = dict(cfg, hidden_size=64, intermediate_size=128, vocab_size=256,
               num_hidden_layers=2)
    w = weights.Weights(cfg, 2 ** 31 + 11, "cpu")
    again = weights.Weights(cfg, 2 ** 31 + 11, "cpu").all()
    other = weights.Weights(cfg, 12, "cpu").all()
    for n in w.names():
        assert torch.equal(w.leaf(n), again[n])
        assert not torch.equal(w.leaf(n), other[n])
    ids = weights.token_ids(3, 1, (2, 8), 256, "cpu")
    assert torch.equal(ids, weights.token_ids(3, 1, (2, 8), 256, "cpu"))
    assert ids.dtype == torch.int32 and int(ids.max()) < 256
    assert np.unique([weights.mix(s, 1) for s in range(100)]).size == 100
