"""Host ms of a fitter's own set-up, from its entry to its first epoch
(copies to the device, Adam's moments, the history and best-state
buffers): the program's ``trainer.setup`` span of each of the window's
fits, the mean over the fits."""
from benchmark import spans


def read(run):
    return spans.per_fit_ms(run, "trainer.setup")
