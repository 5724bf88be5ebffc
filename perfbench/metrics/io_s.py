"""io_s (layer: engines, pipelines/{uncond,lcm,common}.py: the artifact writes drained at the end of an edit): the pipeline's own
timings["io"], each phase ended by a device synchronize, read after each
request; mean per edit."""

UNIT = "s"


def read(run):
    done = [r for r in run.done if "io" in r.timings]
    return sum(r.timings["io"] for r in done) / len(done) if done else None
