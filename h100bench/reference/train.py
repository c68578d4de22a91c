"""Plain reference of the first train steps, and the comparison that
decides a training cell's ``correct``.

:func:`follow` starts from the benchmark's weights and runs the steps the
program ran, on the same uint8 batches and the same per-step seeds: the
input transform (``augment.py``), the per-class imputation from the train
split's means, the forward in train mode (``model.py``), the mean
cross-entropy, the global-norm clip where the configuration has one, and
AdamW written out (decoupled decay first, then the bias-corrected moment
step), with the BatchNorm running statistics moved by each step's batch
statistics. It reads what the comparison needs: each step's loss, each
leaf's gradient norm at step 1 (clipped, as the optimizer gets it), each
leaf's change over the steps, and step 1's transformed batch.

:func:`compare` turns the program's readings and the reference's into the
numbers: each step's loss gap as a share of the reference's loss (step
1's, and the worst step's), the worst and the median leaf's gap of
gradient norms and of change norms, each as a share of the reference's
norm of that leaf or of the median leaf (whichever is larger), and the
widest gap of step 1's transformed batch. A cell's ``limits/<cell>.json``
says which of them are compared.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import augment as A
from . import model as M


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def follow(model: dict, hyper: dict, aug: dict, weights: dict,
           batches: list, seeds: list, means: np.ndarray, out_size: int,
           device, precision: str = "f32", aug_dtype=torch.float32,
           rows: int | None = None, dtype=torch.float32) -> dict:
    """Run ``len(batches)`` train steps from ``weights`` ({name: tensor}).

    ``batches``: host (uint8 images, f32 features, int labels) numpy
    arrays; ``seeds``: (augment seed, dropout seed) a step; ``means``: the
    (classes, F) imputation table. ``precision``: the operands of convs
    and products (``model.Precision``); ``aug_dtype``: the transform's
    arithmetic. ``rows``: only the first ``rows`` rows of each batch enter
    the loss (a planted fault). ``dtype``: the working precision of the
    model (float64 in the tests). → readings (see the module
    docstring)."""
    _tf32_off()
    prec = M.Precision(precision)
    P = {n: w.detach().to(device, dtype).clone() for n, w in
         weights.items()}
    params = [n for n in P if not M.is_buffer(n)]
    for n in params:
        P[n].requires_grad_(True)
    start = {n: t.detach().clone() for n, t in P.items()}
    lr, wd, clip = hyper["lr"], hyper["weight_decay"], hyper["grad_clip"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    m1 = {n: torch.zeros_like(P[n]) for n in params}
    m2 = {n: torch.zeros_like(P[n]) for n in params}
    table = torch.as_tensor(means, device=device)
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for t, ((imgs, feats, labels), (s_aug, s_drop)) in enumerate(
            zip(batches, seeds), start=1):
        imgs = torch.as_tensor(imgs).to(device)
        feats = torch.as_tensor(feats).to(device)
        labels = torch.as_tensor(labels).to(device).long()
        g = torch.Generator(device=device)
        g.manual_seed(s_aug)
        x = A.augment(imgs, g, out_size, aug, dtype=aug_dtype)
        f = A.impute(feats.to(aug_dtype), labels, table.to(aug_dtype)).float()
        if t == 1:
            out["images"], out["features"] = x.detach(), f.detach()
        if rows is not None:
            x, f, labels = x[:rows], f[:rows], labels[:rows]
        g = torch.Generator(device=device)
        g.manual_seed(s_drop)
        stats: dict = {}
        logits = M.forward(model, P, x.to(dtype), f.to(dtype), train=True,
                           generator=g,
                           prec=prec, stats=stats)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, [P[n] for n in params])
        if clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(gr) for gr in grads]))
            grads = [gr * (clip / torch.clamp(norm, min=clip)) for gr in grads]
        out["loss"].append(float(loss.detach()))
        if t == 1:
            out["grad_norm"] = {n: float(torch.linalg.vector_norm(gr))
                                for n, gr in zip(params, grads)}
        with torch.no_grad():
            for n, gr in zip(params, grads):
                p = P[n]
                p.mul_(1 - lr * wd)
                m1[n].mul_(b1).add_(gr, alpha=1 - b1)
                m2[n].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = (m2[n].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m1[n], denom, value=-lr / (1 - b1 ** t))
            for bn, (mean, var) in stats.items():
                P[bn + ".running_mean"].mul_(0.9).add_(mean, alpha=0.1)
                P[bn + ".running_var"].mul_(0.9).add_(var, alpha=0.1)
        del logits, loss, grads
    out["change_norm"] = {n: float(torch.linalg.vector_norm(
        P[n].detach() - start[n])) for n in P}
    return out


def _median(values) -> float:
    return float(np.median(np.asarray(list(values), np.float64)))


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, median ‖ref‖)."""
    names = list(names)
    med = _median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def moved_leaves(ref: dict) -> list:
    """The leaves whose change is compared: every BN statistic, and every
    parameter whose reference gradient is at least a thousandth of the
    median leaf's (below that Adam moves a leaf by round-off alone)."""
    grads = ref["grad_norm"]
    floor = 1e-3 * _median(grads.values())
    return [n for n in ref["change_norm"]
            if M.is_buffer(n) or grads.get(n, 0.0) >= floor]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers (see the module docstring): ``loss_gap_step1`` and
    ``loss_gap`` (the worst of the steps), ``grad_gap`` and ``change_gap``
    (the worst leaf) with ``grad_gap_median`` and ``change_gap_median``
    (the median leaf), and ``batch_gap``."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                  ref["loss"])]
    grad = leaf_gaps(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"])
    change = leaf_gaps(prog["change_norm"], ref["change_norm"],
                       moved_leaves(ref))
    if prog["images"].shape != ref["images"].shape:
        batch = float("inf")
    else:
        batch = max(float((prog[k].float().cpu()
                           - ref[k].float().cpu()).abs().max())
                    for k in ("images", "features"))
    return {"loss_gap_step1": losses[0], "loss_gap": max(losses),
            "grad_gap": max(grad), "grad_gap_median": _median(grad),
            "change_gap": max(change), "change_gap_median": _median(change),
            "batch_gap": batch}
