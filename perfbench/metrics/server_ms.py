"""server_ms (layer: server, serve.py): the client's seconds of a request
minus the server's own `secs` around the locked edit, mean per edit: JSON,
base64, HTTP and the lock."""

UNIT = "ms"


def read(run):
    done = run.done
    return 1e3 * sum(r.client_s - r.secs for r in done) / len(done) if done else None
