"""Device ms an epoch of the ``ops`` wrappers' own work around their
kernels (weight stacking, output buffers, the gradients' unstacking): the
program's ``wrappers.*`` spans less the ``kernels.*`` spans inside them, in
the profiled stretch, over its epochs."""
from benchmark import spans


def read(run):
    return spans.own_ms(run, "wrappers", "kernels")
