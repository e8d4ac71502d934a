"""Attention calls per keystep (calls): the port's count of
``ops/attention.py::multi_head_attention`` calls, whichever core each took
(the fused kernel, its plain version, slot competition), over the
keysteps every Actioner of the process predicted (``Actioner.keysteps``),
read after the run.  The warm-up, window and traced keysteps each make
the same calls, and the check runs the reference alone.  None where the
program counts no such calls or no keysteps."""

import importlib


def read(run):
    keysteps = getattr(importlib.import_module("act3d_tpu_torch.eval.actioner").Actioner,
                       "keysteps", 0)
    calls = getattr(importlib.import_module("act3d_tpu_torch.ops.attention").multi_head_attention,
                    "calls", None)
    if not keysteps or calls is None:
        return None
    return calls / keysteps
