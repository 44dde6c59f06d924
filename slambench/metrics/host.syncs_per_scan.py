"""Host-device syncs a scan: the sum of the program's ``sync.*`` counters
(each device-to-host read, and each copy to the card from pageable host
memory, counted where it is made) over the traced slice
(``utils.spans.profiled``), over the slice's scans. None where the slice
saw no kernel run or the program keeps no such record."""


def _profiled(run):
    t = run.trace
    if not t or not t["scans"] or not t["launches"]:
        return None
    try:
        from icp_tpu_torch.utils import spans
        return spans.profiled()
    except (ImportError, AttributeError):
        return None


def read(run):
    rec = _profiled(run)
    if not rec:
        return None
    n = sum(v for k, v in rec["counts"].items() if k.startswith("sync."))
    return n / run.trace["scans"]
