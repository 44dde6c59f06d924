"""Index-aligned translational RMSE of the program's poses against the
generator's ground truth over the traffic's fixed set of scans, taken after
the window (frozen ``ate``)."""


def read(run):
    return run.ate_m
