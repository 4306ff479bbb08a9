#!/usr/bin/env python3
"""Whether a fit's time per iteration depends on what ran before it in the
same process, on one GPU.

Runs ITERS iterations of the sweep app's MFN SISR fit (host-bound: about
3.6 ms of device work per iteration) and of its MFN denoise fit
(device-bound), or with ``--ct`` of the WIRE-300 and WIRE-2D CT fits
(the CT protocol, 'auto' = fourier; tools/port_step_profile.py's
``--ct auto`` and ``--wire2d ct``), in three states of one process:
  fresh     after a 5-iteration warm-up fit of each (libraries built and
            loaded, allocator warm);
  profiled  after a torch.profiler session (CPU and CUDA activities) over
            a 5-iteration fit of the first kind, as chip_smoke.py's
            measure phase takes its kernels' device times;
  emptied   the same, after torch.cuda.empty_cache().
Before each state's fits it times the host's cost of one small PyTorch
kernel launch (the mean over 2,000 ``torch.add`` calls on a one-element
tensor).  Prints one JSON line per state: ms per iteration of each fit
(CUDA events, FitResult.step_ms), host wall ms per iteration, the launch
cost in microseconds, and nvidia-smi's name and power limit.

With ``--smoke PATH`` it runs that ``chip_smoke.py`` in this process
instead (the package beside it is the one imported), with every cyclic
garbage collection of 10 ms or more printed as a JSON line between the
smoke's phase lines: its generation, length and the objects it freed.

    python3 tools/port_fit_state.py [ITERS] [--ct]   # default 300
    python3 tools/port_fit_state.py --smoke chip_smoke.py
"""
import json
import os
import subprocess
import sys
import time


def trace_gc(smoke_path):
    import gc
    import runpy
    started = []

    def callback(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
            return
        ms = (time.perf_counter() - started.pop()) * 1e3
        if ms >= 10.0:
            print(json.dumps({"gc": info["generation"], "ms": ms,
                              "collected": info["collected"]}), flush=True)

    gc.callbacks.append(callback)
    sys.argv = [smoke_path]
    runpy.run_path(smoke_path, run_name="__main__")


def launch_us(dev, calls=2000):
    import torch
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        x = torch.add(x, 1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def main():
    if sys.argv[1:2] == ["--smoke"]:
        return trace_gc(os.path.abspath(sys.argv[2]))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from port_step_profile import ct_fit, mfn_fit, wire2d_fit
    from wire_tpu_torch.device import resolve

    args = sys.argv[1:]
    ct = "--ct" in args
    args = [a for a in args if a != "--ct"]
    iters = int(args[0]) if args else 300
    dev = resolve("cuda")
    if ct:
        kinds = {"wire_ct": lambda n: ct_fit(n, "auto", dev),
                 "wire2d_ct": lambda n: wire2d_fit(n, "ct", dev)}
    else:
        kinds = {f"mfn_{path}": lambda n, path=path: mfn_fit(n, path, dev)
                 for path in ("sisr", "denoise")}
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    fits = {name: build(iters) for name, build in kinds.items()}
    for build in kinds.values():
        build(5)()

    def state(name):
        out = {"state": name, "iters": iters, "nvidia_smi": smi,
               "launch_us": launch_us(dev)}
        for fit, run in fits.items():
            res = run()
            out[f"{fit}_ms_per_iter"] = res.step_ms
            out[f"{fit}_wall_ms_per_iter"] = res.wall_time_s * 1e3 / iters
        print(json.dumps(out), flush=True)

    state("fresh")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        next(iter(kinds.values()))(5)()
        torch.cuda.synchronize()
    state("profiled")
    torch.cuda.empty_cache()
    state("emptied")


if __name__ == "__main__":
    main()
