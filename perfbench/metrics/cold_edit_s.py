"""cold_edit_s (layer: server, serve.py): the `request.edit` span of the
first edit the process served, the warm-up, whose first use of every
kernel and cuDNN shape is in set-up, in seconds (perfbench/spans.py)."""

from perfbench import spans

UNIT = "s"


def read(run):
    rec = spans.recording(run)
    edits = [s for s in rec.spans if s.name == spans.EDIT] if rec is not None else []
    return min(edits, key=lambda s: s.t0_ns).seconds if edits else None
