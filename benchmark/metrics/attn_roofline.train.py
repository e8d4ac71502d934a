"""The attention kernels' share of their roofline over the traced training
steps (%): the tensor-core bound of every forward and backward attention
call a step makes (the training model's sites from its adapter, at the
configuration's widths and the cell's batch, benchmark/work.py) over the
device time of the kernels whose names hold one of PATTERNS.  The bound
counts the work, whatever kernel does it."""

from benchmark import models, work

PATTERNS = ("mha_fwd", "mha_bwd", "sum_slabs")


def read(run):
    n = run.layer.get("steps_traced")
    if not n or run.traced is None:
        return None
    seconds = run.traced.kernel_seconds(PATTERNS)
    if not seconds:
        return None
    cfg = run.config
    sites = models.adapter(cfg, cfg["train_model"]).sites(cfg, run.traffic["batch"],
                                                          training=True)
    return 100.0 * n * (work.bound_s(sites) + work.bound_s(sites, backward=True)) / seconds
