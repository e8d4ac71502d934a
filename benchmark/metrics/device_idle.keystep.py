"""The device's idle share of a keystep (%): 1 - the device's busy time a
traced keystep (the union of kernel and copy intervals) over the host time
of an untraced keystep of the same run (the profiler slows the host, not
the device)."""


def read(run):
    n, seconds = run.layer.get("keysteps_traced"), run.layer.get("untraced_keystep_s")
    if run.traced is None or not n or not seconds or not run.traced.busy_s:
        return None
    return 100.0 * (1.0 - run.traced.busy_s / n / seconds)
