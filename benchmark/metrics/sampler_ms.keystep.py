"""The trajectory sampler's part of a keystep (ms): ``compute_trajectory``
between the synchronized phase marks of ``Actioner.predict(timed=True)``
(``last_phase_seconds["sampler"]``), mean over the traced keysteps."""


def read(run):
    seconds = run.layer.get("sampler_s")
    return None if seconds is None else seconds * 1e3
