"""Device time a traced training step spends in the sort and top-k kernels
(ms): in a planner training step only the head's trajectory-nearest
selection (``ops/geometry.py::find_traj_nn``, a stable sort of each row's
distances) launches such kernels, read through ``Traced.kernel_seconds``
over the kernels whose names hold one of PATTERNS.  None where no such
kernel ran, as in a head that selects nothing."""

PATTERNS = ("sort", "Sort", "topk", "TopK")


def read(run):
    n = run.layer.get("steps_traced")
    if not n or run.traced is None:
        return None
    seconds = run.traced.kernel_seconds(PATTERNS)
    if not seconds:
        return None
    return 1e3 * seconds / n
