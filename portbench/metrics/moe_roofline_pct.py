"""moe_roofline_pct: the cell's first ``layer.MoE`` timed alone, forward
and backward (its inputs' and its weights' gradients), over the cell's
tokens as a captured CUDA graph; the bound of the routed work alone
(harness/flops.py: N · k rows, three products, forward and backward)
over its time, in %."""

import torch

from harness import flops, trace


def probe(rec):
    if rec.get("kind") != "train" or rec["device"].type != "cuda":
        return None
    from singa_tpu_torch import autograd, layer
    moes = [m for m in rec["model"].modules() if isinstance(m, layer.MoE)]
    if not moes:
        return None
    moe = moes[0]
    cfg, mix = rec["cell"].config, rec["cell"].mix
    N, D = mix["batch"] * mix["seq_len"], cfg["hidden_size"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((N, D), generator=g, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(True)
    dy = torch.randn((N, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    params = [p for p in moe.parameters()]
    was = autograd.is_training()
    autograd.set_training(False)       # no balance loss kept per call
    try:
        seconds = trace.cuda_time_s(
            lambda: torch.autograd.grad(moe(x), [x] + params, dy))
    finally:
        autograd.set_training(was)
    f, nbytes = flops.moe_fwd_bwd(N, cfg["num_experts_per_tok"],
                                  cfg["num_local_experts"], D,
                                  cfg["intermediate_size"])
    bound, by = flops.bound_s(f, nbytes)
    return {"seconds": seconds, "bound_s": bound, "bound_by": by}


def read(rec):
    p = rec.get("probes", {}).get("moe_roofline_pct")
    if not p:
        return None
    return flops.pct(p["bound_s"] / p["seconds"])
