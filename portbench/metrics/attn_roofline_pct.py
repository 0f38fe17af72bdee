"""attn_roofline_pct: the model's attention entry (``ops.attention``:
the banded entry where the window is shorter than the sequence, else
the causal one) timed alone, forward and backward, at the cell's shape
as a captured CUDA graph; its bound from shapes (harness/flops.py)
over its time, in %.  The bound does not depend on which kernel runs."""

import torch

from harness import flops, trace


def _shape(rec):
    cfg, mix = rec["cell"].config, rec["cell"].mix
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return (mix["batch"], mix["seq_len"], H, K, cfg["hidden_size"] // H,
            cfg.get("sliding_window") or 0)


def probe(rec):
    if rec.get("kind") != "train" or rec["device"].type != "cuda":
        return None
    from singa_tpu_torch.ops import attention as attn
    B, T, H, K, D, W = _shape(rec)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def t(heads):
        return torch.randn((B, T, heads, D), generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(True)
    q, k, v = t(H), t(K), t(K)
    do = torch.randn((B, T, H, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)

    def step():
        o = attn.banded_attention(q, k, v, W) if W and W < T \
            else attn.attention(q, k, v, causal=True)
        torch.autograd.grad(o, (q, k, v), do)
    f, nbytes = flops.attention_fwd_bwd(B, T, H, K, D, W if W < T else 0)
    bound, by = flops.bound_s(f, nbytes)
    seconds = trace.cuda_time_s(step)
    return {"seconds": seconds, "bound_s": bound, "bound_by": by}


def read(rec):
    p = rec.get("probes", {}).get("attn_roofline_pct")
    if not p:
        return None
    return flops.pct(p["bound_s"] / p["seconds"])
