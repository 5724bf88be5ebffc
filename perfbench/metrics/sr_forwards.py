"""sr_forwards (layer: sampling, pipelines/superres.py): the program's
`sr_forwards` counter (each U-Net call of the IF-II upscale; the CFG
variants ride on the batch) of the window's requests, mean per edit
(perfbench/spans.py)."""

from perfbench import spans

UNIT = "calls/edit"


def read(run):
    rec = spans.recording(run)
    reqs = spans.window_requests(rec, len(run.records)) if rec is not None else []
    counts = [rec.counts.get(r.request, {}).get("sr_forwards") for r in reqs]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
