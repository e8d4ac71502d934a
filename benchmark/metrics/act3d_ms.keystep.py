"""Act3D's part of a keystep (ms): the host clock between the synchronized
phase marks of ``Actioner.predict(timed=True)`` (``last_phase_seconds
["act3d"]``), mean over the traced keysteps."""


def read(run):
    seconds = run.layer.get("act3d_s")
    return None if seconds is None else seconds * 1e3
