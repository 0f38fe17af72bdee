"""Seeded weights and token ids, made on the device by the benchmark and
handed alike to the program and to the reference.

Each leaf has a seed of its own, drawn from the run's seed and its place
in the model, so that one leaf can be made again alone (the reference
and the change of a leaf after the first steps need the starting value
of one leaf at a time, beside a model that fills the card).  A leaf is
one generator call on the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

GOLDEN = 0x9E3779B97F4A7C15
MASK63 = (1 << 63) - 1


def mix(seed: int, *salt: int) -> int:
    """A 63-bit seed from `seed` and `salt`, stable across processes."""
    h = (int(seed) * GOLDEN) & MASK63
    for s in salt:
        h = ((h ^ (int(s) + 0x632BE59BD9B4E019)) * GOLDEN) & MASK63
        h ^= h >> 29
    return h


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter, in the program's names and
    (in, out) layout.  kind: 'table', 'norm', or 'in:<fan-in>'."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    F = cfg["intermediate_size"]
    hd = D // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd
    E = cfg.get("num_local_experts", 0)
    out = [("tok_emb.table", (V, D), "table")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [(p + "attn_norm.gamma", (D,), "norm"),
                (p + "attn.q_proj.W", (D, D), f"in:{D}"),
                (p + "attn.k_proj.W", (D, kv), f"in:{D}"),
                (p + "attn.v_proj.W", (D, kv), f"in:{D}"),
                (p + "attn.o_proj.W", (D, D), f"in:{D}"),
                (p + "ffn_norm.gamma", (D,), "norm")]
        if E:
            out += [(p + "ffn.router", (D, E), f"in:{D}"),
                    (p + "ffn.w_in", (E, D, F), f"in:{D}"),
                    (p + "ffn.w_out", (E, F, D), f"in:{F}"),
                    (p + "ffn.w_gate", (E, D, F), f"in:{D}")]
        else:
            out += [(p + "ffn.gate.W", (D, F), f"in:{D}"),
                    (p + "ffn.up.W", (D, F), f"in:{D}"),
                    (p + "ffn.down.W", (F, D), f"in:{F}")]
    out += [("norm_f.gamma", (D,), "norm"), ("lm_head.W", (D, V), f"in:{D}")]
    return out


class Weights:
    """The weights of `cfg` for `seed` on `device`, rounded to `dtype`
    (the type they are served or trained in) and held in f32."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.float32):
        self.cfg, self.seed = cfg, int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self._spec = {n: (i, s, k) for i, (n, s, k) in enumerate(leaves(cfg))}

    def names(self) -> List[str]:
        return list(self._spec)

    def leaf(self, name: str) -> torch.Tensor:
        """Leaf `name`, made again from its own seed: normal with standard
        deviation 1/sqrt(fan-in) for a product's weight, 0.02 for the
        embedding, 1 + 0.05 · normal for a norm's gain."""
        i, shape, kind = self._spec[name]
        g = torch.Generator(device=self.device)
        g.manual_seed(mix(self.seed, 1, i))
        w = torch.randn(shape, generator=g, device=self.device,
                        dtype=torch.float32)
        if kind == "table":
            w.mul_(0.02)
        elif kind == "norm":
            w.mul_(0.05).add_(1.0)
        else:
            w.mul_(float(kind[3:]) ** -0.5)
        if self.dtype != torch.float32:
            w = w.to(self.dtype).float()
        return w

    def all(self) -> Dict[str, torch.Tensor]:
        return {n: self.leaf(n) for n in self._spec}

    def load_into(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy every leaf into the program's parameter of that name, in
        its storage, one leaf at a time."""
        missing = set(self._spec) ^ set(params)
        if missing:
            raise KeyError(f"the program's parameters and the benchmark's "
                           f"differ: {sorted(missing)[:6]}")
        with torch.no_grad():
            for n in self._spec:
                params[n].copy_(self.leaf(n))


def token_ids(seed: int, salt: int, shape, vocab: int, device) -> torch.Tensor:
    """Uniform token ids (int32) of `shape` drawn on `device`."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(mix(seed, 2, salt))
    return torch.randint(0, vocab, tuple(shape), generator=g,
                         device=torch.device(device), dtype=torch.int64
                         ).to(torch.int32)
