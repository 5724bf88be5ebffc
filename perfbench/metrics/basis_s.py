"""basis_s (layer: edit algebra, editing/{pullback,nullspace,walk}.py: the masked-Jacobian bases and their projection): the pipeline's own
timings["basis"], each phase ended by a device synchronize, read after each
request; mean per edit."""

UNIT = "s"


def read(run):
    done = [r for r in run.done if "basis" in r.timings]
    return sum(r.timings["basis"] for r in done) / len(done) if done else None
