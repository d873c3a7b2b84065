"""Host ms inside the session's ``step()`` per edit: update, refresh,
upload, bake, tables and the launch (the benchmark's ``bench.step`` span)."""


def read(view, run):
    return view.host_ms("bench.step")
