"""Where the port could still depend on the order of a device's writes.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 -m icp_tpu_torch.tools.determinism_audit
    python3 -m icp_tpu_torch.tools.determinism_audit --sites [PYTEST ARGS]

Without ``--sites`` (on a card): every phase of chip_smoke.py (from the
working directory) runs under ``torch.use_deterministic_algorithms(True,
warn_only=True)``. Each op torch has no deterministic form of warns, and
the audit prints it once with the port's call site that reached it (the
innermost frame in icp_tpu_torch or chip_smoke.py), then a sorted list of
every (op, site) pair, whatever the run's outcome. The flag also fills
fresh tensors with NaN and swaps in slower kernels, so the run's times
mean nothing; the package itself never sets it. Exit code 1 when
chip_smoke.py failed.

The flag silently swaps a deterministic form in for the ops whose CUDA
form writes in no fixed order (index_put_, index_add_, index_copy_,
scatter_, scatter_add_, scatter_reduce_), so that run cannot name them.
``--sites`` (on the CPU: the call sites are the same) runs pytest with the
given arguments under a torch function mode that records every call of
those ops from icp_tpu_torch, by call site, and whether its indices
repeated a slot: a site whose slots never repeat gives the same result in
any order.
"""
import os
import runpy
import sys
import traceback
import warnings


def main() -> int:
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    seen = {}

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        sites = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.name}"
                 for f in stack if ("icp_tpu_torch" in f.filename
                                    or "chip_smoke" in f.filename)]
        key = (str(message).split(",")[0][:160],
               sites[-1] if sites else f"{filename}:{lineno}")
        if key not in seen:
            seen[key] = sites[-3:]
            print(f"[audit] {key[0]} @ {key[1]}  (via "
                  f"{' <- '.join(reversed(sites[-3:-1]))})", flush=True)

    warnings.showwarning = show
    warnings.simplefilter("always")
    sys.argv = ["chip_smoke.py"]
    rc = 0
    try:
        runpy.run_path("chip_smoke.py", run_name="__main__")
    except BaseException as e:      # report the audit whatever the run did
        rc = 1
        print(f"[audit] chip_smoke ended with {type(e).__name__}: {e}",
              flush=True)
    finally:
        print(f"[audit] {len(seen)} distinct (op, site) pairs:", flush=True)
        for (msg, site), _ in sorted(seen.items(), key=lambda kv: kv[0][1]):
            print(f"[audit]   {site}: {msg}", flush=True)
    return rc


# ops whose CUDA form writes in no fixed order where slots repeat
_WATCH = {"index_put_", "index_put", "__setitem__", "index_add_", "index_add",
          "index_copy_", "index_copy", "scatter_", "scatter", "scatter_add_",
          "scatter_add", "scatter_reduce_", "scatter_reduce", "put_"}


def _slots(name, args, kwargs):
    """The written positions as rows of a (K, ndim) int tensor, or None
    where the call writes through no integer index."""
    import torch

    if name == "__setitem__":
        idx = args[1] if isinstance(args[1], tuple) else (args[1],)
        ints = [i for i in idx if isinstance(i, torch.Tensor)
                and not i.dtype == torch.bool]
        if not ints or any(not isinstance(i, torch.Tensor) for i in idx):
            return None
        return torch.stack(torch.broadcast_tensors(*ints), -1).reshape(
            -1, len(ints))
    if name in ("index_put_", "index_put"):
        ints = [i for i in args[1] if i is not None and i.dtype != torch.bool]
        if not ints:
            return None
        return torch.stack(torch.broadcast_tensors(*ints), -1).reshape(
            -1, len(ints))
    if name == "put_":
        return args[1].reshape(-1, 1)
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    index = args[2] if len(args) > 2 else kwargs.get("index")
    if not isinstance(index, torch.Tensor):
        return None
    if name.startswith("index_"):
        return index.reshape(-1, 1)
    grids = torch.meshgrid(*[torch.arange(n) for n in index.shape],
                           indexing="ij")
    pos = [g.reshape(-1) for g in grids]
    pos[dim % index.dim()] = index.reshape(-1).cpu()
    return torch.stack(pos, -1)


def sites(pytest_args) -> int:
    import pytest
    import torch
    from torch.overrides import TorchFunctionMode

    seen = {}

    class SiteLog(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if name in _WATCH:
                stack = [f for f in traceback.extract_stack()[:-1]
                         if "icp_tpu_torch" in f.filename
                         and "determinism_audit" not in f.filename]
                if stack:
                    f = stack[-1]
                    # the mode is off inside its own handler
                    pos = _slots(name, args, kwargs)
                    dup = (pos is not None and len(pos) > 0 and
                           torch.unique(pos.cpu(), dim=0).shape[0] < len(pos))
                    site = (f"{os.path.relpath(f.filename)}:{f.lineno}", name)
                    calls, dups = seen.get(site, (0, 0))
                    if pos is not None:
                        seen[site] = (calls + 1, dups + int(dup))
            return func(*args, **kwargs)

    with SiteLog():
        rc = pytest.main(list(pytest_args))
    print(f"[sites] {len(seen)} call sites of order-sensitive writes in "
          f"icp_tpu_torch (calls, calls whose slots repeated):", flush=True)
    for (site, name), (calls, dups) in sorted(seen.items()):
        print(f"[sites]   {site} {name}: {calls} calls, {dups} with repeated "
              f"slots", flush=True)
    return int(rc)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sites"]:
        sys.exit(sites(sys.argv[2:]))
    sys.exit(main())
