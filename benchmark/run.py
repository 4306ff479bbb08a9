#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root, on a machine with the card(s) the cell asks for.
Set-up (imports, the CUDA context, the kernel libraries, a warm-up fit at
the cell's shapes) is ``setup_s``; then whole fits run back to back for
``--seconds`` (the window), each from its own seed drawn from ``--seed``;
then every fit's output is checked against the plain reference
(``check.py``).  The last line of standard output is one JSON object:
``correct``, ``attempted`` and ``failed`` (fits), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
profiled stretch of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines of standard error.

Exits with another code than 0, and prints no result, without the cards,
or when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``wire_tpu`` is
loaded once the window has closed.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the build and kernel caches a run may write, at fixed paths in the
# checkout (the port's own libraries go to wire_tpu_torch/_build/)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CHECKOUT, "benchmark", "_cache", _sub)
# one intra-op thread: the fits are paced by the card or by the one host
# thread that dispatches to it (the host-paced cells ran faster so)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

FORBIDDEN = ("jax", "jaxlib", "flax", "wire_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``: ``wire_tpu_torch`` is not ``wire_tpu``."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def report(probe, wall, stretch, cell_run):
    """What the run did, on standard error before the checks."""
    epochs = sum(len(f["intervals_ms"]) for f in probe.fits)
    print(f"window {wall:.3f} s: {len(probe.fits)} fits, {epochs} epoch "
          f"intervals (the samples of epoch_ms_p95)", file=sys.stderr)
    for f in probe.fits:
        extra = f" ssim {f['ssim']}" if "ssim" in f else ""
        print(f"fit seed {f['seed']}: {f['epochs']} epochs x {f['rows']} "
              f"rows x {f['replicas']}, psnr {f['psnr']}{extra}",
              file=sys.stderr)
    if stretch is not None:
        from benchmark.counts import classes
        per_epoch = {k: us / 1e3 / stretch.epochs
                     for k, us in stretch.kernels.items()}
        print(f"profiled {stretch.epochs} epochs in {stretch.window_s:.3f} "
              f"s; ms an epoch by class: "
              f"{classes.by_class(per_epoch, cell_run.ctx.kernels)}",
              file=sys.stderr)


def main(argv=None):
    args = parse(argv)
    from benchmark import lookup
    spec = lookup.benchmark_spec(CHECKOUT)
    cell = lookup.cell(spec, args.workload)
    import torch
    torch.set_num_threads(1)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    from benchmark.harness import CellRun
    cell_run = CellRun(spec, args.workload, "cuda")
    cell_run.warm_up(args.seed)
    setup_s = time.time() - T_START
    torch.cuda.reset_peak_memory_stats(0)
    probe, wall = cell_run.window(args.seed, args.seconds,
                                 trace_on=bool(args.trace))
    device = device_info(torch, cell["chips"])
    metrics, stretch = cell_run.metrics(probe, wall, setup_s,
                                       bool(args.trace))
    correct, rows = cell_run.verdict(probe.fits)
    result = {"correct": bool(correct), "attempted": len(probe.fits),
              "failed": 0, "metrics": metrics, "device": device}
    if stretch is not None:
        device["busy_s"] = stretch.busy_us() / 1e6
        device["window_s"] = stretch.window_s
        result["breakdown"] = stretch.breakdown()
    result["checks"] = {name: {"value": float(v), "limit": lim}
                        for name, v, lim in rows}
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    report(probe, wall, stretch, cell_run)
    for name, v, lim in rows:
        print(f"check {name} = {float(v)!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
