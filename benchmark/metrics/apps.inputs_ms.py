"""Host ms a fit spends building the app's inputs from its seed (the
stand-in image, its halving, the noise; the CT field and sinogram): the
program's ``apps.inputs`` spans within each of the window's fits, the mean
over the fits."""
from benchmark import spans


def read(run):
    return spans.per_fit_ms(run, "apps.inputs")
