"""Device kernel events per training step in the traced stretch: what
``Trainer.step`` dispatches from the host."""


def read(run):
    n = run.layer.get("steps_traced")
    if not n or run.traced is None or not run.traced.kernel_events:
        return None
    return run.traced.kernel_events / n
