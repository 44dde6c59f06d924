"""Share of the (row, target) pairs that ``nn_cuda`` computed in the
traced slice that were real work: 100 x the program's ``nn.pairs_valid``
(valid source rows x valid targets x live ICP iterations, summed on the
card) over ``nn.pairs_computed`` (padded rows x padded targets of every
launch), from ``utils.spans.profiled``. The rest is padding and the
masked iterations after ICP's stop flag within a chunk. None where the
slice saw no kernel run, launched no ``nn_cuda`` or the program keeps no
such record."""


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
    done = rec["counts"].get("nn.pairs_computed", 0)
    if not done:
        return None
    return 100.0 * rec["counts"].get("nn.pairs_valid", 0) / done
