"""Time the history path's fetch on the card part by part, and hold the
event log to another checkout's.

    python -m pvtrace_tpu_torch.kernels.fetch [--rounds 3] [--against DIR]

On the mesh LSC (seed 15) with the log at 1000 (2**27 photons) and at 1
(2**17), after one ``kernels.trace``: in turns, ``--rounds`` times, the
dense fetch the port made before the pack (the log allocated and filled on
the device, a pageable ``.cpu()`` of it, the counts scanned from its rows)
and the fetch it makes now (``api.fetch_log``: ``pvt_log_pack``, pinned
copies, ``eventlog.unpack``), then three unpacks of the same records: one
boolean mask per array, flat indices on one thread, and ``eventlog.unpack``
(flat indices, a thread per range of slots). With ``--against DIR`` (another
checkout's ``csrc``) this checkout's tracer library and DIR's are built
with ``-fmad=false`` and their logs compared: fates, longest photon, dense
ints and floats bit for bit, counts (DIR's from its rows: each build writes
into a filled log, so one that writes no counts compares too). Prints the
card's nvidia-smi line; exits non-zero when the unpacks or the logs differ.
Needs a CUDA device.
"""
import argparse
import hashlib
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import api, compile_scene, eventlog, rng, scene_tensors
from pvtrace_tpu_torch.kernels import build, check, variants
from pvtrace_tpu_torch.scenes import mesh_lsc

RUNS = ((1 << 27, 1000), (1 << 17, 1))


def _ms(fn):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - tic) * 1e3


def dense_fetch(log):
    """The fetch before the pack, on a kernel's `log`: the device log's
    allocation and fill, the pageable copy of a log of that size, the
    counts from its rows. Returns their ms."""
    S, E = log["ints"].shape[:2]
    filled, fill_ms = _ms(lambda: eventlog.empty(S, E, torch.float32, log["ints"].device))
    filled["ints"], filled["floats"] = check.dense_log(log)
    (ints, _), copy_ms = _ms(lambda: (filled["ints"].cpu().numpy(),
                                      filled["floats"].cpu().numpy()))
    tic = time.perf_counter()
    (ints[..., 0] >= 0).sum(axis=1).astype(np.int32)
    return fill_ms, copy_ms, (time.perf_counter() - tic) * 1e3


def mask_unpack(counts, ints, floats, S, E):
    used = np.arange(E) < counts[:, None]
    dense_ints = np.full((S, E, eventlog.LOG_I), -1, np.int32)
    dense_floats = np.zeros((S, E, eventlog.LOG_F), np.float32)
    dense_ints[used] = ints
    dense_floats[used] = floats
    return dense_ints, dense_floats


def flat_unpack(counts, ints, floats, S, E):
    starts = np.cumsum(counts, dtype=np.int64) - counts
    dst = np.repeat(np.arange(S, dtype=np.int64) * E - starts, counts) + np.arange(len(ints))
    dense_ints = np.full((S * E, eventlog.LOG_I), -1, np.int32)
    dense_floats = np.zeros((S * E, eventlog.LOG_F), np.float32)
    dense_ints[dst] = ints
    dense_floats[dst] = floats
    return dense_ints.reshape(S, E, -1), dense_floats.reshape(S, E, -1)


def threaded_unpack(counts, ints, floats, S, E):
    return eventlog.unpack(counts, ints, floats, S, E, np.float32)


@contextmanager
def filled_logs():
    """kernels.trace's logs filled (-1, 0), as an older build needs them."""
    given = kernels.empty_log
    kernels.empty_log = lambda *args, fill=True: given(*args, fill=True)
    try:
        yield
    finally:
        kernels.empty_log = given


def compare_logs(st, seed, against):
    """This checkout's log and `against`'s (csrc), both built with
    -fmad=false: True when every field is equal."""
    libs = variants.build_variants({"this": variants._sources(build.CSRC),
                                    "against": variants._sources(Path(against))}, "tracer",
                                   ["-fmad=false"])
    same_all = True
    for n, every in RUNS:
        got = {}
        for label, (handle, _) in libs.items():
            kernels._libs["tracer"] = handle
            with filled_logs():
                fates, longest, _, log = kernels.trace(st, seed, n, record_every=every)
            counts = (log["ints"][..., 0] >= 0).sum(1).to(torch.int32)
            if label == "this" and not torch.equal(counts, log["counts"]):
                print(f"fetch: the log's counts differ from its rows, log {every}", flush=True)
                same_all = False
            got[label] = (fates.cpu(), longest, log["ints"].cpu(),
                          log["floats"].cpu().view(torch.int32), counts.cpu())
            del log
        same = [torch.equal(a, b) if torch.is_tensor(a) else a == b
                for a, b in zip(got["this"], got["against"])]
        same_all = same_all and all(same)
        print(f"fetch -fmad=false, log {every} at {n}: fates, longest photon, ints, floats "
              f"(bits), counts equal to {against}'s: {same}; records {int(got['this'][4].sum())}",
              flush=True)
    kernels._libs.pop("tracer", None)
    return same_all


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--against", default=None, help="another checkout's csrc directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fetch: needs a CUDA device")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    st = scene_tensors(compile_scene(mesh_lsc()), dtype=torch.float32, device="cuda")
    seed, ok = rng.key_words(15), True
    for n, every in RUNS:
        _, _, _, log = kernels.trace(st, seed, n, record_every=every)
        S, E = log["ints"].shape[:2]
        for r in range(args.rounds):
            for way in ("dense", "packed")[::-1 if r % 2 else 1]:
                if way == "dense":
                    fill, copy, scan = dense_fetch(log)
                    print(f"fetch log {every} at {n}, round {r}, dense: fill {fill:.3f} ms, "
                          f"pageable copy {copy:.2f} ms ({(S * E * 72) / copy / 1e6:.3f} GB/s), "
                          f"counts scan {scan:.2f} ms", flush=True)
                else:
                    _, total = _ms(lambda: api.fetch_log(log, np.float32))
                    part = api.last_fetch
                    print(f"fetch log {every} at {n}, round {r}, packed: {total:.2f} ms, pack "
                          f"{part['pack_s'] * 1e3:.2f} ms (kernel {part['pack_ms']:.4f}), copy "
                          f"{part['copy_s'] * 1e3:.2f} ms of {part['bytes']} bytes, unpack "
                          f"{part['unpack_s'] * 1e3:.2f} ms", flush=True)
        counts = log["counts"].cpu().numpy()
        ints, floats = (t.cpu().numpy() for t in kernels.log_pack(log))
        del log
        digest = None
        for r in range(args.rounds):
            for fn in (mask_unpack, flat_unpack, threaded_unpack)[::-1 if r % 2 else 1]:
                tic = time.perf_counter()
                out = fn(counts, ints, floats, S, E)
                ms = (time.perf_counter() - tic) * 1e3
                h = hashlib.sha256(out[0].tobytes() + out[1].tobytes()).hexdigest()
                digest = digest or h
                ok = ok and h == digest
                print(f"fetch log {every} at {n}, round {r}, unpack {fn.__name__}: {ms:.2f} ms"
                      f"{'' if h == digest else ' DIFFERS'}", flush=True)
                del out
    if args.against:
        ok = compare_logs(st, seed, args.against) and ok
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if not ok:
        raise SystemExit("fetch: the unpacks or the logs differ")


if __name__ == "__main__":
    main()
