"""A client of the studio's event streams, for scripts and tests that
drive the CLI and the studio and read what a viewer would see.

* ``captured(app, argv)``: a CLI call with its standard output kept;
* ``sse_messages(url)``: the messages of one Server-Sent Events GET
  (``/api/run``, ``/api/watch``) until ``done``;
* ``watch_run(app, argv)``: a ``simulate --watch --no-browser`` with a
  viewer registered on its ``/api/watch`` before the run starts;
* ``recorder_ints`` and ``tally_ints``: a ``bundle`` message's recorders,
  or a run's tallies in the same form, as integers to compare.
"""
import contextlib
import io
import json
import sys
import threading
import urllib.request

import numpy as np

from pvtrace_tpu_torch.studio.server import _recorder_payload


def captured(app, argv):
    """`app(argv)` with its standard output captured: (rc, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = app(argv)
    return rc, out.getvalue()


def sse_messages(url, started=None, timeout=600):
    """The messages of one Server-Sent Events GET of `url` until ``done``
    (or the stream's end); `started`, an Event, is set on the first. An
    HTTP error (a 409 while a run goes) raises ``urllib.error.HTTPError``."""
    messages = []
    with urllib.request.urlopen(url, timeout=timeout) as response:
        kind = response.headers["Content-Type"]
        if not kind.startswith("text/event-stream"):
            raise ValueError(f"{url} answered {kind}, not an event stream")
        for raw in response:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            messages.append(json.loads(line[len("data: "):]))
            if started is not None:
                started.set()
            if messages[-1].get("type") == "done":
                break
    return messages


def watch_run(app, argv, timeout=600):
    """`app(argv)` (a ``simulate --watch --no-browser``) with a viewer on
    its watch server: the URL is read from the command's standard error
    as it starts, and the command waits there until a client thread is
    registered on ``/api/watch`` (the server adds a client before its
    response headers), which then reads until ``done``. Returns (rc,
    stdout, the messages)."""
    messages, registered, base = [], threading.Event(), []

    class Tee(io.TextIOBase):
        def write(self, text):
            if text.startswith("live view: ") and not base:
                base.append(text.split("live view: ")[1].split("/?")[0])
                thread.start()
                if not registered.wait(timeout):
                    raise RuntimeError("the viewer did not connect to /api/watch")
            return sys.__stderr__.write(text)

    def viewer():
        with urllib.request.urlopen(base[0] + "/api/watch", timeout=timeout) as response:
            registered.set()
            for raw in response:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    messages.append(json.loads(line[len("data: "):]))
                    if messages[-1]["type"] == "done":
                        return

    thread = threading.Thread(target=viewer, daemon=True)
    with contextlib.redirect_stderr(Tee()):
        rc, said = captured(app, argv)
    thread.join(timeout=timeout)
    return rc, said, messages


def recorder_ints(payload):
    """A bundle message's recorders as integers: rays, crossings and
    every histogram bin, by recorder."""
    return {name: (r["rays"], r["crossings"], [h["values"] for h in r["histograms"]])
            for name, r in payload.items()}


def tally_ints(compiled, distinct, crossings, bins):
    """A run's recorder tallies (``rec_distinct``, ``rec_crossings``,
    ``rec_bins``, summed over its bundles) as ``recorder_ints`` gives a
    bundle message's."""
    n_rec = len(compiled.recorder_names)
    return recorder_ints(_recorder_payload(compiled, distinct, crossings,
                                           np.zeros((n_rec, 4, 2)), bins))
