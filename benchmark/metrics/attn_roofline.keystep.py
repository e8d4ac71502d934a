"""The attention kernels' share of their roofline over the traced keysteps
(%): the tensor-core bound of every attention call a keystep makes (the
sites of each role's adapter from the configuration's widths,
benchmark/work.py) over the device time of the kernels whose names hold
one of PATTERNS.  The bound counts the work, whatever kernel does it."""

from benchmark import models, work
from benchmark.drivers.keystep import ROLES

PATTERNS = ("mha_fwd", "mha_bwd", "sum_slabs")


def read(run):
    n = run.layer.get("keysteps_traced")
    if not n or run.traced is None:
        return None
    seconds = run.traced.kernel_seconds(PATTERNS)
    if not seconds:
        return None
    cfg = run.config
    sites = [site for role in ROLES
             for site in models.adapter(cfg, role).sites(cfg, 1, training=False)]
    return 100.0 * n * work.bound_s(sites) / seconds
