"""readbacks (layer: engines, pipelines/common.py::_host and the waits
routed like it): the program's `readbacks` counter (each copy to the host
and each synchronize the served edit waits on) of the window's requests,
mean per edit (perfbench/spans.py)."""

from perfbench import spans

UNIT = "calls/edit"


def read(run):
    rec = spans.recording(run)
    reqs = spans.window_requests(rec, len(run.records)) if rec is not None else []
    if not reqs:
        return None
    return sum(rec.counts.get(r.request, {}).get("readbacks", 0) for r in reqs) / len(reqs)
