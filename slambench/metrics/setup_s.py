"""From process start to the first hand-over (host clock): imports, the
kernels' build or load, the traffic made from the seed and the warm pass."""


def read(run):
    return run.setup_s
