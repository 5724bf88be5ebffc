"""forwards (layer: models, models/adm and models/sd): forward calls of the
served model modules (a pre-hook each, registered by the harness; a vmap,
jvp or vjp calls forward once), mean per edit."""

UNIT = "calls/edit"


def read(run):
    done = run.done
    return sum(r.forwards for r in done) / len(done) if done else None
