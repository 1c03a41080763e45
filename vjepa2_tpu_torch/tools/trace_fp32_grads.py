"""Where the fp32 ViT-L step's clip-0 gradients part from the CPU's.

`chip_smoke.py` phase train_fp32 holds clip 0's loss and gradients of the
fp32 ViT-L step on the card to the fp32 CPU path (phase train's weights,
clip and masks) and reads ~5e-5 relative L2 on the gradients. This tool
computes the same loss and gradients three ways on one card and its host:

* ``kernels``: the card as the step runs it (cuBLAS fp32 GEMMs, TF32 off;
  the fp32 flash kernels, 3xTF32);
* ``plain``: the card with the attention's plain versions in place of the
  fp32 flash kernels (`flash_attention._plain_fwd` / `_plain_bwd`), every
  other op the same;
* ``cpu``: the CPU's fp32 path;

and prints each pair's relative L2 on the loss, on each model's flattened
gradients and block by block (encoder and predictor blocks, then the rest),
as one JSON line; once with the step's loss (L1, ``loss_exp`` 1) and once
with ``loss_exp`` 2. If ``plain`` sits as far from ``cpu`` as ``kernels``
does, the flash kernels are not where the gap comes from; if the gap is
flat over the blocks and goes with the L1 loss, it comes from that loss's
sign(pred - target) at residuals within rounding of 0 (each flip moves
that element's cotangent by 2 / its count, and the backward carries the
difference into every block).

Run on the H100 machine from the repository root (needs `chip_smoke.py`):

    python -m vjepa2_tpu_torch.tools.trace_fp32_grads
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import time

import torch


@contextlib.contextmanager
def plain_attention():
    """While active, the BHND flash entry points run their plain versions on
    a CUDA tensor too (outputs laid out as the kernels write them)."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    saved = fa._flash_fwd_cuda, fa._flash_bwd_cuda

    def fwd(q, k, v, *args):
        out, lse = fa._plain_fwd(q, k, v, *args)
        return fa._out_layout(out).copy_(out), lse.contiguous()

    fa._flash_fwd_cuda, fa._flash_bwd_cuda = fwd, fa._plain_bwd
    try:
        yield
    finally:
        fa._flash_fwd_cuda, fa._flash_bwd_cuda = saved


def _group(name: str) -> str:
    m = re.match(r"(?:predictor_)?blocks\.(\d+)\.", name)
    return f"block {int(m.group(1)):02d}" if m else "other"


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("trace_fp32_grads: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tr = cs._Trainer(dev, "vit_large", dtype=torch.float32)
    tp = tr.tp
    me, mp = cs._masks(tr.coll, cs.CLIPS)
    me0, mp0 = [torch.from_numpy(m[:1]) for m in me], [torch.from_numpy(m[:1]) for m in mp]

    def loss_and_grads(e, p, tgt, x, me_, mp_, loss_exp):
        h = tp.target_features(tgt, x, mp_)
        e.zero_grad(set_to_none=True)
        p.zero_grad(set_to_none=True)
        loss = tp.forward_loss(e, p, x, me_, mp_, h, loss_exp)
        loss.backward()
        grads = {f"{k}.{n}": q.grad.detach().float().cpu()
                 for k, m in (("encoder", e), ("predictor", p)) for n, q in m.named_parameters()}
        return loss.item(), grads

    to_dev = lambda ms: [m.to(dev) for m in ms]  # noqa: E731
    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    enc_cpu, pred_cpu = tr.build("cpu", torch.float32)
    tgt_cpu, _ = tr.build("cpu", torch.float32)
    enc_cpu.load_state_dict(tr.enc.state_dict())
    pred_cpu.load_state_dict(tr.pred.state_dict())
    tgt_cpu.load_state_dict(tr.state.target_encoder.state_dict())
    card = (tr.enc, tr.pred, tr.state.target_encoder, tr.clips[:1], to_dev(me0), to_dev(mp0))
    cpu = (enc_cpu, pred_cpu, tgt_cpu, tr.clips[:1].float().cpu(), me0, mp0)
    result = {}
    for loss_exp in (tr.hp.loss_exp, 2.0):
        runs = {"kernels": loss_and_grads(*card, loss_exp)}
        with plain_attention():
            runs["plain"] = loss_and_grads(*card, loss_exp)
        runs["cpu"] = loss_and_grads(*cpu, loss_exp)
        result[f"loss_exp {loss_exp:g}"] = {
            f"{a}_vs_{b}": compare(runs, a, b)
            for a, b in (("kernels", "cpu"), ("plain", "cpu"), ("kernels", "plain"))}
    print(json.dumps({"tool": "trace_fp32_grads", "model": "vit_large step at fp32, clip 0",
                      "gpu": cs.phase_device(), **result,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def compare(runs, a, b) -> dict:
    """Relative L2 of run ``a`` against run ``b``: the loss, each model's
    flattened gradients and each block's."""
    (la, ga), (lb, gb) = runs[a], runs[b]
    out = {"loss_rel": abs(la - lb) / abs(lb)}
    for model in ("encoder", "predictor"):
        names = [n for n in gb if n.startswith(model + ".")]
        out[f"{model}_grad_rel_l2"] = _rel(*(torch.cat([g[n].flatten() for n in names])
                                            for g in (ga, gb)))
        groups: dict = {}
        for n in names:
            groups.setdefault(_group(n.split(".", 1)[1]), []).append(n)
        out[f"{model}_by_block"] = {
            key: _rel(*(torch.cat([g[n].flatten() for n in ns]) for g in (ga, gb)))
            for key, ns in sorted(groups.items())}
    return out


if __name__ == "__main__":
    sys.exit(main())
