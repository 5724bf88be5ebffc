"""strips_s (layer: sampling, diffusion/{sampling,lcm}.py: the walk strips denoised (and decoded)): the pipeline's own
timings["strips"], each phase ended by a device synchronize, read after each
request; mean per edit."""

UNIT = "s"


def read(run):
    done = [r for r in run.done if "strips" in r.timings]
    return sum(r.timings["strips"] for r in done) / len(done) if done else None
