"""Device ms an epoch of Adam's update: the program's ``trainer.adam``
spans (CUDA events at ``Adam.step``'s entry and exit) in the profiled
stretch, over its epochs."""
from benchmark import spans


def read(run):
    return spans.stretch_ms(run, "trainer.adam")
