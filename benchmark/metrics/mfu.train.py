"""The whole training step's share of the card's peak (%): the model FLOPs
of one forward and backward, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
reference at the cell's batch, over the host time of an untraced step of
the same run (the profiler slows the host) times the peak of the
configuration's precision (float32: 67 TFLOP/s)."""

from benchmark.work import PEAK_FLOPS


def read(run):
    flops, seconds = run.layer.get("flops_per_step"), run.layer.get("untraced_step_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS[run.config["precision"]])
