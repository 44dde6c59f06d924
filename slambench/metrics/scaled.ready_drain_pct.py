"""Share of the scaled pipeline's readiness checks in the traced slice
that found the card done with the pending steps and bookkept them at once:
100 x the program's ``scaled.ready_drains`` over ``scaled.ready_checks``
(one check a step that finds steps pending), from
``utils.spans.profiled``. A step after a drain that left nothing pending
(the one before a closure check) makes no check. None where the slice saw
no kernel run, made no check or the program keeps no such record."""


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
    checks = rec["counts"].get("scaled.ready_checks", 0)
    if not checks:
        return None
    return 100.0 * rec["counts"].get("scaled.ready_drains", 0) / checks
