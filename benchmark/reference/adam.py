"""Adam (Kingma and Ba, arXiv:1412.6980) with the apps' per-epoch
exponential decay, written out, and the first steps of a fit driven by it.

Step t (from 0): g = dloss/dp; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
p -= lr_t (m / (1 - b1^(t+1))) / (sqrt(v / (1 - b2^(t+1))) + eps), with
lr_t = learning_rate x lr_decay^min(t / epochs, 1), the rate decaying to
lr_decay x over the fit's epochs (one step an epoch), and for the
pointwise fits (``scale_lr_by_batch``) times min(1, maxpoints / rows).
"""
from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def first_steps(params, loss_fn, traffic, rows, steps=3):
    """Drive ``steps`` Adam steps from ``params`` ({path: tensor}).
    Returns (the loss before each step, the first step's gradient, the
    parameters after the last step), each a float or {path: tensor}."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, g0 = [], None
    scale = (min(1.0, traffic["maxpoints"] / rows)
             if traffic.get("scale_lr_by_batch") else 1.0)
    for t in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        losses.append(float(loss.detach()))
        if g0 is None:
            g0 = {k: g.clone() for k, g in grads.items()}
        lr = traffic["learning_rate"] * traffic["lr_decay"] ** min(
            t / traffic["epochs"], 1.0) * scale
        with torch.no_grad():
            for k in p:
                m[k] = B1 * m[k] + (1 - B1) * grads[k]
                v2[k] = B2 * v2[k] + (1 - B2) * grads[k] * grads[k]
                mhat = m[k] / (1 - B1 ** (t + 1))
                vhat = v2[k] / (1 - B2 ** (t + 1))
                p[k] = p[k] - lr * mhat / (torch.sqrt(vhat) + EPS)
    return losses, g0, p


def flat(tree, prefix=""):
    """{path: tensor} of a nested dict, paths joined with '/'."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def nest(leaves):
    """The nested dict of ``flat``'s {path: tensor}."""
    out = {}
    for path, v in leaves.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
