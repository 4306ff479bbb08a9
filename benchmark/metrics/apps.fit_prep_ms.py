"""Host time a fit spends outside its epoch loop (harness clock): from the
fit's start (the app's inputs, model, init, the fitter's own set-up) to its
first epoch boundary, plus from the fitter's return to the fit's end (the
app's metrics); the mean over the run's fits."""


def read(run):
    per = [(f["t_loop0"] - f["t0"]) + (f["t1"] - f["t_loop1"])
           for f in run.fits]
    return 1e3 * sum(per) / len(per)
