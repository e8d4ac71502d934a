"""The attention kernels' share of their roofline over the traced training
steps (%): the tensor-core bound of every forward and backward attention
call a step makes (its sites from the configuration's widths at the cell's
batch, benchmark/work.py) over the device time of the kernels whose names
hold one of PATTERNS.  The bound counts the work, whatever kernel does it."""

from benchmark import work

PATTERNS = ("mha_fwd", "mha_bwd", "sum_slabs")


def read(run):
    n = run.layer.get("steps_traced")
    if not n or run.traced is None:
        return None
    seconds = run.traced.kernel_seconds(PATTERNS)
    if not seconds:
        return None
    cfg, batch = run.config, run.traffic["batch"]
    shared = {"ncam": cfg["ncam"], "instruction_tokens": cfg["instruction_tokens"]}
    if cfg["train_model"] == "act3d":
        sites = work.act3d_sites({**cfg["act3d"], **shared}, batch, training=True)
    else:
        sites = work.planner_sites({**cfg["planner"], **shared}, batch)
    return 100.0 * n * (work.bound_s(sites) + work.bound_s(sites, backward=True)) / seconds
