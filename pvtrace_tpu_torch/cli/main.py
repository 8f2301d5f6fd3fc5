"""Command-line interface of the port.

Port of ``pvtrace_tpu.cli.main``, the reference ``pvtrace/cli/main.py``
(typer) on argparse: ``pvtrace-tpu-torch-cli simulate scene.yml`` traces
a YAML scene with the port's engine and writes every event to a SQLite
database with the reference ``ray``/``event`` schema;
``count``/``spectrum``/``time`` query it; ``show`` renders the scene to a
standalone HTML file; ``studio`` serves the port's studio.

``simulate`` and ``studio`` take ``--device`` (default ``cuda``: the
hand-written kernels on the card; ``cpu``: the eager PyTorch twin). A
missing card, or a kernel that fails to build or launch, ends the
command with its error; only a scene the compiler refuses
(``UnsupportedSceneError``) falls back to the per-ray oracle, as in the
JAX package. A budget of 0 rays writes an empty database, as the JAX
package's empty stream does.
"""
import argparse
import os
import sqlite3
import sys

import numpy as np

from pvtrace_tpu_torch.light.event import Event


def prepare_database(path):
    schema = os.path.join(
        os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
        "data",
        "schema.sql",
    )
    if os.path.exists(path):
        os.remove(path)
    connection = sqlite3.connect(path)
    with open(schema) as fh:
        connection.executescript(fh.read())
    connection.commit()
    return connection


def write_history(cursor, throw_id, history):
    for ray, event, metadata in history:
        metadata = metadata or {}
        cursor.execute(
            "INSERT INTO ray VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                throw_id,
                *[float(v) for v in ray.position],
                *[float(v) for v in ray.direction],
                float(ray.wavelength),
                ray.source,
                float(ray.travelled),
                float(ray.duration),
            ),
        )
        ray_id = cursor.lastrowid
        normal = metadata.get("normal") or (None, None, None)
        cursor.execute(
            "INSERT INTO event VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                ray_id,
                event.name,
                metadata.get("component"),
                metadata.get("hit"),
                metadata.get("container"),
                metadata.get("adjacent"),
                metadata.get("facet"),
                normal[0],
                normal[1],
                normal[2],
            ),
        )


def _start_watch_server(args):
    """Studio server thread + browser tab for `simulate --watch`:
    the trace loop below broadcasts live progress (recorder tallies,
    sampled ray paths, rays/s) to every connected viewer — the
    reference's monitor-thread live meshcat view, re-done over SSE
    (reference cli/main.py:85-161)."""
    import threading

    from pvtrace_tpu_torch.studio.server import create_server

    server = create_server(
        document_path=args.scene, host="127.0.0.1", port=args.port,
        device=args.device,
    )
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/?watch=1"
    print(f"live view: {url}", file=sys.stderr)
    if not getattr(args, "no_browser", False):
        import webbrowser

        webbrowser.open(url)
    return server


def cmd_simulate(args):
    from pvtrace_tpu_torch.cli.parse import parse

    scene = parse(args.scene)
    if args.tracer != "python":
        from pvtrace_tpu_torch.engine.api import require_device

        require_device(args.device)
    database = args.database or (os.path.splitext(args.scene)[0] + ".sqlite3")
    connection = prepare_database(database)
    cursor = connection.cursor()

    watch_server = _start_watch_server(args) if args.watch else None

    rays = args.rays
    traced = 0
    if args.tracer == "python":
        if watch_server:
            print(
                "note: --watch live tallies need the device engine; the "
                "python tracer writes SQLite only", file=sys.stderr,
            )
        histories = _python_histories(scene, rays, args.seed)
        for throw_id, history in enumerate(histories):
            write_history(cursor, throw_id, history)
            traced += 1
            if traced % 100 == 0:
                connection.commit()
    else:
        from pvtrace_tpu_torch import engine
        from pvtrace_tpu_torch.engine.compiler import UnsupportedSceneError

        try:
            import time as time_module

            import numpy as np

            from pvtrace_tpu_torch.studio.server import (
                _extract_paths,
                _histogram_meta,
                _recorder_payload,
            )

            compiled = engine.compile_scene(scene)
            n_rec = len(compiled.recorder_names)
            distinct = np.zeros(n_rec, dtype=np.int64)
            crossings = np.zeros(n_rec, dtype=np.int64)
            sums = np.zeros((n_rec, 4, 2), dtype=np.float64)
            bins = np.zeros(int(compiled.total_bins), dtype=np.int64)
            sent_paths = 0
            tic = time_module.perf_counter()
            if watch_server:
                watch_server.watch_broadcast(
                    {
                        "type": "started",
                        "total": rays,
                        "histograms": _histogram_meta(compiled),
                    }
                )

            throw_id = 0
            # The JAX package's stream of a budget of 0 yields nothing;
            # the port's simulate_stream refuses one when called.
            stream = engine.simulate_stream(
                scene, rays, bundle=min(rays, args.bundle), seed=args.seed,
                record_every=1, compiled=compiled, device=args.device,
            ) if rays > 0 else ()
            for result, done in stream:
                for history in result.histories():
                    full = [(r, e, m) for r, e, m in history]
                    write_history(cursor, throw_id, full)
                    throw_id += 1
                connection.commit()
                if watch_server:
                    distinct += result.data["rec_distinct"]
                    crossings += result.data["rec_crossings"]
                    sums += result.data["rec_sums"].reshape(n_rec, 4, 2)
                    bins += result.data["rec_bins"]
                    paths = []
                    if sent_paths < 200:
                        paths = _extract_paths(result, 200 - sent_paths)
                        sent_paths += len(paths)
                    elapsed = time_module.perf_counter() - tic
                    watch_server.watch_broadcast(
                        {
                            "type": "bundle",
                            "traced": done,
                            "total": rays,
                            "rays_per_second": done / elapsed
                            if elapsed > 0 else 0,
                            "recorders": _recorder_payload(
                                compiled, distinct, crossings, sums, bins
                            ),
                            "paths": paths,
                        }
                    )
                print(f"traced {done}/{rays}", file=sys.stderr)
            traced = throw_id
            if watch_server:
                watch_server.watch_broadcast(
                    {
                        "type": "done",
                        "elapsed": time_module.perf_counter() - tic,
                    }
                )
        except UnsupportedSceneError as err:
            print(f"engine unavailable ({err}); using python tracer",
                  file=sys.stderr)
            for throw_id, history in enumerate(
                _python_histories(scene, rays, args.seed)
            ):
                write_history(cursor, throw_id, history)
                traced += 1
    connection.commit()
    connection.close()
    print(f"Wrote {traced} ray histories to {database}")
    if watch_server and args.hold_watch:
        print("watch server running; Ctrl-C to exit", file=sys.stderr)
        try:
            while True:
                import time as time_module

                time_module.sleep(1.0)
        except KeyboardInterrupt:
            pass
    return 0


def _python_histories(scene, rays, seed):
    from pvtrace_tpu_torch.algorithm import photon_tracer

    if seed is not None:
        np.random.seed(seed)
    for ray in scene.emit(rays):
        yield list(photon_tracer.step_forward(scene, ray))


def cmd_show(args):
    from pvtrace_tpu_torch.cli.parse import parse
    from pvtrace_tpu_torch.scene.renderer import SceneRenderer

    scene = parse(args.scene)
    renderer = SceneRenderer(open_browser=args.open_browser)
    renderer.render(scene)
    if args.rays:
        from pvtrace_tpu_torch.algorithm import photon_tracer

        np.random.seed(args.seed or 0)
        for ray in scene.emit(args.rays):
            renderer.add_history(
                list(photon_tracer.step_forward(scene, ray))
            )
    path = renderer.save(args.output)
    print(path)
    return 0


def cmd_studio(args):
    from pvtrace_tpu_torch.studio import main as studio_main

    studio_main(
        document_path=args.scene,
        host=args.host,
        port=args.port,
        open_browser=not args.no_browser,
        device=args.device,
    )
    return 0


_EVENT_CHOICES = (
    "entering", "escaping", "reflected", "nonradiative", "reacted", "killed"
)


def _query(args, prefix):
    from pvtrace_tpu_torch.cli import db

    builders = {
        "entering": getattr(db, f"sql_{prefix}_entering_into_node"),
        "escaping": getattr(db, f"sql_{prefix}_escaping_from_node"),
        "reflected": getattr(db, f"sql_{prefix}_reflected_from_node"),
        "nonradiative": getattr(db, f"sql_{prefix}_nonradiative_loss_in_node"),
        "reacted": getattr(db, f"sql_{prefix}_reacted_in_node"),
        "killed": getattr(db, f"sql_{prefix}_killed_in_node"),
    }
    builder = builders[args.event]
    if args.event in ("entering", "escaping", "reflected"):
        sql, params = builder(
            args.node, nx=args.nx, ny=args.ny, nz=args.nz,
            facet=args.facet, source=args.source, atol=args.atol,
        )
    else:
        sql, params = builder(args.node, source=args.source)
    connection = sqlite3.connect(args.database)
    rows = connection.execute(sql, params).fetchall()
    connection.close()
    return rows


def cmd_count(args):
    rows = _query(args, "count")
    print(int(rows[0][0]))
    return 0


def _ascii_histogram(values, bins=20):
    if len(values) == 0:
        return "(no rays)"
    counts, edges = np.histogram(values, bins=bins)
    peak = counts.max() or 1
    lines = []
    for count, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(40 * count / peak)
        lines.append(f"{lo:12.4g} - {hi:12.4g} | {bar} {count}")
    return "\n".join(lines)


def _output_values(args, values, column):
    if args.output == "csv":
        print(column)
        for v in values:
            print(v)
    elif args.output == "json":
        import json

        print(json.dumps(list(values)))
    else:
        print(_ascii_histogram(np.asarray(values), bins=args.bins))


def cmd_spectrum(args):
    rows = _query(args, "spectrum")
    _output_values(args, [row[1] for row in rows], "wavelength")
    return 0


def cmd_time(args):
    rows = _query(args, "time")
    _output_values(args, [row[1] for row in rows], "duration")
    return 0


def _add_query_args(sub):
    sub.add_argument("database")
    sub.add_argument("node")
    sub.add_argument("event", choices=_EVENT_CHOICES)
    sub.add_argument("--nx", type=float, default=None)
    sub.add_argument("--ny", type=float, default=None)
    sub.add_argument("--nz", type=float, default=None)
    sub.add_argument("--facet", default=None)
    sub.add_argument("--source", default=None)
    sub.add_argument("--atol", type=float, default=1e-6)


_DEVICE_HELP = "torch device of the engine: 'cuda' (the card, default) or 'cpu' (the eager twin)"


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pvtrace-tpu-torch-cli",
        description="Monte Carlo photon transport CLI (PyTorch + CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("simulate", help="trace a YAML scene into SQLite")
    p.add_argument("scene")
    p.add_argument("--rays", "-n", type=int, default=10000)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--database", default=None)
    p.add_argument("--bundle", type=int, default=50000)
    p.add_argument(
        "--tracer", choices=("auto", "python"), default="auto",
        help="'python' forces the per-ray oracle tracer",
    )
    p.add_argument(
        "--watch", action="store_true",
        help="open a live browser view of the run (studio viewport)",
    )
    p.add_argument("--port", type=int, default=0,
                   help="watch-server port (0 = ephemeral)")
    p.add_argument("--no-browser", action="store_true")
    p.add_argument(
        "--hold-watch", action="store_true",
        help="keep the watch server alive after the run finishes",
    )
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("show", help="render the scene to standalone HTML")
    p.add_argument("scene")
    p.add_argument("--output", default=None)
    p.add_argument("--rays", type=int, default=0,
                   help="overlay this many traced ray paths")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--open-browser", action="store_true")
    p.set_defaults(func=cmd_show)

    p = sub.add_parser("studio", help="browser-based scene editor + live runs")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8567)
    p.add_argument("--no-browser", action="store_true")
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    p.set_defaults(func=cmd_studio)

    p = sub.add_parser("count", help="count distinct rays for an interaction")
    _add_query_args(p)
    p.set_defaults(func=cmd_count)

    p = sub.add_parser("spectrum", help="wavelengths of matching rays")
    _add_query_args(p)
    p.add_argument("--output", choices=("hist", "csv", "json"), default="hist")
    p.add_argument("--bins", type=int, default=20)
    p.set_defaults(func=cmd_spectrum)

    p = sub.add_parser("time", help="durations of matching rays")
    _add_query_args(p)
    p.add_argument("--output", choices=("hist", "csv", "json"), default="hist")
    p.add_argument("--bins", type=int, default=20)
    p.set_defaults(func=cmd_time)

    return parser


def app(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(app())
