"""Device kernel events per keystep in the traced stretch: what the
sampler's host dispatch has to launch."""


def read(run):
    n = run.layer.get("keysteps_traced")
    if not n or run.traced is None or not run.traced.kernel_events:
        return None
    return run.traced.kernel_events / n
