"""generate_s (layer: sampling, diffusion/{sampling,lcm}.py: generation from x_T (z_T) to the edit step): the pipeline's own
timings["generate"], each phase ended by a device synchronize, read after each
request; mean per edit."""

UNIT = "s"


def read(run):
    done = [r for r in run.done if "generate" in r.timings]
    return sum(r.timings["generate"] for r in done) / len(done) if done else None
