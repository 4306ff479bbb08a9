"""What the task modules share: holding the program's objects to the cell's
files, and driving the reference's first steps of a fit."""
from __future__ import annotations

from benchmark import lookup
from benchmark.reference import adam
from benchmark.reference.matmul import no_tf32


def same(what, got, want):
    """Raise where the program's value departs from the cell's files."""
    if isinstance(want, float) or isinstance(got, float):
        same = abs(float(got) - float(want)) <= 1e-12 * max(1.0, abs(want))
    else:
        same = got == want
    if not same:
        raise RuntimeError(f"the program departs from the cell's files: "
                           f"{what} is {got!r}, the files say {want!r}")


def check_model(model, config, traffic):
    """The model the app built is the configuration at the traffic's
    frequencies: family, widths, depth, omega0 and scale."""
    spec = model.spec
    same("family", spec.nonlin, config["family"])
    for key in ("in_features", "hidden_features", "hidden_layers"):
        same(key, getattr(spec, key), config[key])
    same("scale", spec.scale, traffic["scale"])
    if config["family"] == "wire":
        same("first_omega0", spec.first_omega0, traffic["omega0"])
        same("hidden_omega0", spec.hidden_omega0, traffic["omega0"])


def check_fit(fit_cfg, traffic, niters=None):
    """The fitter's settings are the traffic's (its depth ``niters`` where
    the harness asked for one: the warm-up's)."""
    same("epochs", fit_cfg.niters, niters or traffic["epochs"])
    same("learning_rate", fit_cfg.learning_rate, traffic["learning_rate"])
    same("lr_decay", fit_cfg.lr_decay, traffic["lr_decay"])
    same("maxpoints", fit_cfg.maxpoints, traffic["maxpoints"])
    same("scale_lr_by_batch", fit_cfg.scale_lr_by_batch,
            bool(traffic.get("scale_lr_by_batch", False)))


def reference_steps(ctx, mm, init_gen, coords, loss_of):
    """The reference's first three steps of one fit: the family's init from
    ``init_gen``, then Adam on ``loss_of(pred)``, ``pred`` the family's
    forward at ``coords`` with its products through ``mm``.  Returns
    {losses, p0, g0, p3} with {path: tensor} trees."""
    fam = lookup.module("reference", ctx.config["family"])
    p0 = {k: v.to(ctx.dev) for k, v in adam.flat(
        fam.init(init_gen, ctx.config, ctx.out_features)).items()}

    def loss_fn(leaves):
        return loss_of(fam.apply(adam.nest(leaves), coords, ctx.config,
                                 ctx.traffic, mm))

    with no_tf32():
        losses, g0, p3 = adam.first_steps(p0, loss_fn, ctx.traffic,
                                          coords.shape[0])
    return {"losses": losses, "p0": p0, "g0": g0, "p3": p3}


def rows_half(n, fault):
    """The rows a loss is taken over: all, or with the fault 'half' the
    first half (the mean then taken over those)."""
    return n // 2 if fault == "half" else n
