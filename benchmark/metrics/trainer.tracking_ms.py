"""Device ms an epoch of the best tracking (the epoch's MSE arithmetic, the
history writes, ``_keep_best``'s masked copies): the program's
``trainer.tracking`` spans in the profiled stretch, over its epochs."""
from benchmark import spans


def read(run):
    return spans.stretch_ms(run, "trainer.tracking")
