#!/usr/bin/env python3
"""The readings a cell's check limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --faults 3 --base-seed <n> [--out FILE]

In one process, after the cell's set-up: ``--seeds`` whole fits of the
program, each against the reference (the lower readings); the control,
the reference with TF32 products (``reference/matmul.py:tf32``) put in
the program's place, on ``--control`` seeds; and on ``--faults`` seeds
each fault a cell can have: half of the batch left out, the mean taken
over the rest (planted in the reference put in the program's place), and
an answer altered where it is produced (``OFFSET`` added to the
reconstruction the fit keeps as its best, planted in the program).  A
state left unchanged reads 1 by ``change_gap``'s measure and needs no
run.  Prints one JSON object (and writes it to ``--out``): every reading,
and per number the largest program reading and the smallest reading of
the control and of each fault.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, lookup, window  # noqa: E402
from benchmark.harness import CellRun  # noqa: E402

OFFSET = 1e-2


def as_program(outs):
    """The reference's first steps [one dict a replica] in the shape of a
    fit's record, for ``check.step_numbers``."""
    M = len(outs)

    def stack(key):
        return {p: (torch.stack([o[key][p] for o in outs]) if M > 1
                    else outs[0][key][p]) for p in outs[0][key]}

    return dict(replicas=M, losses=np.array([o["losses"] for o in outs]).T,
                g0=stack("g0"), p0=stack("p0"), p3=stack("p3"))


def loss_steps(fit, refs):
    """Each of the first three steps' loss gap, the worst replica's."""
    losses = np.asarray(fit["losses"], np.float64)
    return [max(abs(losses[t, r] - ref["losses"][t]) / ref["losses"][t]
                for r, ref in enumerate(refs)) for t in range(3)]


def altered_keep_best(trainer):
    keep = trainer._keep_best

    def planted(tracked, best_metric, current, best):
        rec, *rest = current
        return keep(tracked, best_metric, (rec + OFFSET, *rest), best)
    return planted


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--answer", type=int, default=None,
                   help="seeds of the altered-answer fault (default: "
                        "--faults)")
    p.add_argument("--base-seed", type=int, default=1)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from wire_tpu_torch.train import trainer
    cell_run = CellRun(lookup.benchmark_spec(), a.workload, "cuda")
    cell_run.warm_up(a.base_seed)
    out = {"cell": a.workload, "device": torch.cuda.get_device_name(0),
           "program": [], "control": [], "half": [], "answer": []}
    seeds = [window.fit_seed(a.base_seed, k) for k in range(a.seeds)]
    fits = {}
    for s in seeds:
        probe, _ = cell_run.window(s, 0)
        fit = probe.fits[0]
        fits[fit["seed"]] = fit
        refs = cell_run.reference(fit["seed"])
        leaves = []
        out["program"].append(dict(
            seed=fit["seed"], psnr=fit["psnr"],
            loss_steps=loss_steps(fit, refs),
            **check.step_numbers(fit, refs, leaves),
            best_gap=check.best_number(fit, refs), leaves=leaves))
        print(json.dumps(out["program"][-1]), file=sys.stderr, flush=True)
    for fit in list(fits.values())[:a.control]:
        control = as_program(cell_run.reference(fit["seed"], "tf32"))
        refs = cell_run.reference(fit["seed"])
        leaves = []
        out["control"].append(dict(
            seed=fit["seed"], loss_steps=loss_steps(control, refs),
            **check.step_numbers(control, refs, leaves), leaves=leaves))
    for fit in list(fits.values())[:a.faults]:
        leaves = []
        nums = check.step_numbers(as_program(cell_run.reference(
            fit["seed"], fault="half")), cell_run.reference(fit["seed"]),
            leaves)
        out["half"].append(dict(seed=fit["seed"], **nums, leaves=leaves))
    keep = trainer._keep_best
    trainer._keep_best = altered_keep_best(trainer)
    try:
        for s in seeds[:a.faults if a.answer is None else a.answer]:
            probe, _ = cell_run.window(s, 0)
            fit = probe.fits[0]
            out["answer"].append(dict(
                seed=fit["seed"],
                **check.numbers(fit, cell_run.reference(fit["seed"]))))
    finally:
        trainer._keep_best = keep
    out["summary"] = {
        "program_max": {k: max(r[k] for r in out["program"])
                        for k in check.NAMES},
        **{f"{kind}_min": {k: min(r[k] for r in out[kind])
                           for k in check.NAMES if k in out[kind][0]}
           for kind in ("control", "half", "answer") if out[kind]}}
    text = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
