"""Train a character-level LSTM language model: the port's counterpart of
the JAX package's ``examples/rnn/train.py`` (the reference's char-rnn).

    python -m singa_tpu_torch.tools.train_rnn
    python -m singa_tpu_torch.tools.train_rnn --device cpu --steps 40

Next-character prediction over a built-in corpus (``--text`` for a file
of your own): ``CharRNN`` is Embedding → stacked ``layer.LSTM`` →
Linear over the vocabulary, trained with Adam through
``compile(..., use_graph=True)`` and ``train_step`` (a CUDA graph on the
card from the third step); then ``sample`` draws characters through the
eval step.  Defaults are the example's: hidden 128, embed 64, 2 layers,
sequences of 64, batches of 64, Adam 3e-3, 150 steps.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import device as device_mod
from .. import layer, model, opt
from ..device import Device

__all__ = ["CORPUS", "CharRNN", "batches", "sample", "build_parser", "main"]

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
    "sphinx of black quartz, judge my vow. "
    "the five boxing wizards jump quickly. "
    "a mad boxer shot a quick, gloved jab to the jaw of his "
    "dizzy opponent. jackdaws love my big sphinx of quartz. "
    "the jay, pig, fox, zebra and my wolves quack! "
    "few quips galvanized the mock jury box. "
    "crazy fredrick bought many very exquisite opal jewels. "
) * 8


class CharRNN(model.Model):
    """Embedding -> stacked LSTM -> per-step Linear over the vocabulary:
    ``embed.table``, ``rnns.<i>.Wx`` / ``Wh`` / ``b`` and ``head.W`` /
    ``head.b``, as the reference's.  The forward returns (B·T, V)
    logits; the default train step's loss is their softmax
    cross-entropy against the next characters (B·T,)."""

    def __init__(self, vocab: int, hidden: int = 128, embed: int = 64,
                 num_layers: int = 2, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        kw = dict(device=self.device, generator=generator)
        self.vocab = vocab
        self.embed = layer.Embedding(vocab, embed, **kw)
        self.rnns = nn.ModuleList(
            [layer.LSTM(hidden, embed if i == 0 else hidden, **kw)
             for i in range(num_layers)])
        self.head = layer.Linear(vocab, hidden, **kw)

    def forward(self, ids):
        x = self.embed(ids)                       # (B, T, E)
        for rnn in self.rnns:
            x = rnn(x)                            # (B, T, H)
        B, T, H = x.shape
        return self.head(x.reshape(B * T, H))     # (B·T, V)


def batches(data: np.ndarray, batch: int, seqlen: int,
            rng: np.random.RandomState):
    """`batch` random windows of `data`: ids (batch, seqlen) int32 and
    the next characters (batch·seqlen,) int32."""
    starts = rng.randint(0, len(data) - seqlen - 1, size=batch)
    x = np.stack([data[s:s + seqlen] for s in starts])
    y = np.stack([data[s + 1:s + seqlen + 1] for s in starts])
    return x.astype(np.int32), y.reshape(-1).astype(np.int32)


def sample(m: CharRNN, text: str, stoi: Dict[str, int],
           itos: Dict[int, str], n: int, temperature: float = 0.8,
           win: int = 32) -> str:
    """`n` characters after the corpus' first `win`, each drawn (numpy
    seed 0) from the last position's softmax over a window of the last
    `win` characters, so every eval call has the shape (1, win)."""
    rng = np.random.RandomState(0)
    dev = m.device.torch_device
    ids = [stoi[c] for c in text[:win]]
    m.eval()
    for _ in range(n):
        ctx = torch.as_tensor(np.asarray(ids[-win:], np.int32)[None, :],
                              device=dev)
        logits = m(ctx).float().cpu().numpy()
        logits = logits.reshape(ctx.shape[1], -1)[-1] / max(temperature,
                                                            1e-3)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        ids.append(int(rng.choice(len(p), p=p)))
    return "".join(itos[i] for i in ids)


def build_parser() -> argparse.ArgumentParser:
    """The example's options (its own, and the ``--batch-size`` and
    ``--lr`` it reads from ``examples/common.base_parser``), with the
    port's ``--device``.  Weights and batches come from seed 0, and the
    loss is printed every tenth of the steps, as in the example."""
    p = argparse.ArgumentParser(
        description="char-level LSTM LM (the port's examples/rnn)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--text", default=None, help="path to a text corpus")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seqlen", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--sample", type=int, default=120,
                   help="characters to sample after training")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train, print the loss and chars/s, sample; returns what it
    printed.  chars/s counts the steps after the capture (from the
    fourth), each ending in a read of its loss."""
    args = build_parser().parse_args(argv)
    if args.text:
        with open(args.text) as f:
            text = f.read()
    else:
        text = CORPUS
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    itos = {i: c for c, i in stoi.items()}
    data = np.asarray([stoi[c] for c in text], np.int32)
    print(f"corpus: {len(text)} chars, vocab {len(chars)}", flush=True)

    dev = device_mod.create_device(args.device)
    gen = torch.Generator(dev.torch_device).manual_seed(0)
    m = CharRNN(len(chars), hidden=args.hidden, num_layers=args.layers,
                device=dev, generator=gen)
    m.set_optimizer(opt.Adam(lr=args.lr))
    rng = np.random.RandomState(0)
    x0, _ = batches(data, args.batch_size, args.seqlen, rng)
    m.compile([x0], is_train=True, use_graph=True)
    every = max(1, args.steps // 10)
    losses, t0 = [], None
    warm = min(3, args.steps - 1)
    for step in range(args.steps):
        x, y = batches(data, args.batch_size, args.seqlen, rng)
        _, loss = m.train_step(torch.as_tensor(x, device=dev.torch_device),
                               torch.as_tensor(y, device=dev.torch_device))
        losses.append(loss.item())
        if step == warm - 1:
            t0 = time.perf_counter()
        if step % every == 0 or step == args.steps - 1:
            print(f"step {step:4d}: loss {losses[-1]:.4f}", flush=True)
    steady = args.steps - warm
    cps = (args.batch_size * args.seqlen * steady
           / (time.perf_counter() - t0)) if t0 and steady > 0 else None
    if cps:
        print(f"{cps:,.0f} chars/s over steps {warm}-{args.steps - 1}",
              flush=True)
    graph = m.get_graph("train")
    out = {"steps": args.steps, "losses": losses, "chars_per_s": cps,
           "vocab": len(chars), "device": str(dev.torch_device),
           "train_captured": graph is not None and graph.graph is not None}
    if args.sample:
        out["sample"] = sample(m, text, stoi, itos, args.sample)
        print("--- sample ---")
        print(out["sample"], flush=True)
    return out


if __name__ == "__main__":
    main()
