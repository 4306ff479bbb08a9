"""Device time an iteration of the Fourier-slice operator: cuFFT's kernels
and the port's spectrum gather and scatter, in the profiled stretch.
Nothing where the stretch ran no FFT."""


def read(run):
    s = run.stretch
    if s is None or s.by_owner["cufft"] == 0:
        return None
    sampler = sum(us for name, us in s.kernels.items()
                  if "spectrum_gather_kernel" in name
                  or "spectrum_scatter_kernel" in name)
    return (s.by_owner["cufft"] + sampler) / 1e3 / s.epochs
