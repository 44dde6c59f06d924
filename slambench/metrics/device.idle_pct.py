"""Share of the traced slice's wall time in which no kernel ran on the
card: 100 minus the union of the kernel intervals of ``torch.profiler``'s
device trace over the slice's length."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["launches"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
