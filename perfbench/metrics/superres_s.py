"""superres_s (layer: sampling, pipelines/superres.py: the IF-II upscale of
the strip's frames): the pipeline's own timings["superres"], the phase
ended by a device synchronize, read after each request; mean per edit."""

UNIT = "s"


def read(run):
    done = [r for r in run.done if "superres" in r.timings]
    return sum(r.timings["superres"] for r in done) / len(done) if done else None
