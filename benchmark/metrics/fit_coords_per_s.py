"""Fit throughput: rows x epochs x replicas of every whole fit in the
window, over the window's wall time (the first fit's preparation to the
last fit's results on the host)."""


def read(run):
    done = sum(f["rows"] * f["epochs"] * f["replicas"] for f in run.fits)
    return done / run.window_s
