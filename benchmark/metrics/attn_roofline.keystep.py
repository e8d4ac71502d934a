"""The attention kernels' share of their roofline over the traced keysteps
(%): the tensor-core bound of every attention call a keystep makes (its
sites from the configuration's widths, benchmark/work.py) over the device
time of the kernels whose names hold one of PATTERNS.  The bound counts
the work, whatever kernel does it."""

from benchmark import work

PATTERNS = ("mha_fwd", "mha_bwd", "sum_slabs")


def read(run):
    n = run.layer.get("keysteps_traced")
    if not n or run.traced is None:
        return None
    seconds = run.traced.kernel_seconds(PATTERNS)
    if not seconds:
        return None
    cfg = run.config
    shared = {"ncam": cfg["ncam"], "instruction_tokens": cfg["instruction_tokens"]}
    sites = (work.act3d_sites({**cfg["act3d"], **shared}, 1, training=False)
             + work.planner_sites({**cfg["planner"], **shared}, 1,
                                  per_denoise=cfg["planner"]["diffusion_timesteps"]))
    return 100.0 * n * work.bound_s(sites) / seconds
