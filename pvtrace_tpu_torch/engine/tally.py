"""K9: recorder tallies, the eager twin.

Port of ``_empty_tallies`` and ``_tally`` (pvtrace_tpu/engine/tracer.py)
and of the tally frame of ``body_fast``, for one step's events from
``physics.step``. Like the JAX function it builds one [B, R] match
matrix: a lane matches recorder r when its ``tnode`` and ``sel`` are the
recorder's node and event and, for a facet recorder, the lane has a
world normal (``have_n``) within ``atol`` of the facet on all three
axes. Every match adds to ``cross``; the first match of a photon (``seen``
[B, R], cleared when a lane is refilled) adds to ``distinct``, to the
eight moment sums (wavelength, angle, duration, pathlength and their
squares; angle = arccos(c_in) on surface events, else 0) and to the
recorder's histograms. Binning is the reference's expression,
``floor((v - lo) / (hi - lo) * n)`` in the run's dtype, with values out
of range dropped; x, y and z are the position in ``tnode``'s local frame.

With score channels (K12) the first match also adds the photon's path
score, this step's contributions included, to ``rec_scores`` [R, CH];
``fate_scores`` [11, CH] is kept here too (``score.fold`` adds to it).

Counters are int64 (the JAX package's int32 ``cross`` and ``bins`` can
wrap, ROADMAP queue 3); sums are in the run's dtype. The tallies are
updated in place.
"""
import torch

from pvtrace_tpu_torch.engine import tables as T


def empty(st, B, channels=0):
    """Zero tallies of `B` lanes: ``distinct`` and ``cross`` [max(R, 1)],
    ``sums`` [max(R, 1), 8], ``bins`` [total_bins] and ``seen`` [B, max(R, 1)],
    and with `channels` score channels ``fate_scores`` [11, channels] and
    ``rec_scores`` [max(R, 1), channels], the sums of their addends'
    magnitudes ``fate_abs`` and ``rec_abs``, each channel's largest
    per-photon magnitude folded or matched, ``score_max`` [channels], and
    the sums of the scores' slack (``score.py``), ``fate_slack`` and
    ``rec_slack`` (float64)."""
    meta, dev = st["meta"], st["node_f"].device
    R = max(meta["n_rec"], 1)
    f = dict(dtype=st["node_f"].dtype, device=dev)
    scores = {
        name: torch.zeros(shape, **f) for name, shape in (
            ("fate_scores", (11, channels)), ("fate_abs", (11, channels)),
            ("rec_scores", (R, channels)), ("rec_abs", (R, channels)),
            ("score_max", (channels,)),
        )
    } if channels else {}
    if channels:
        scores["fate_slack"] = torch.zeros((11, channels), dtype=torch.float64, device=dev)
        scores["rec_slack"] = torch.zeros((R, channels), dtype=torch.float64, device=dev)
    return {
        **scores,
        "distinct": torch.zeros(R, dtype=torch.int64, device=dev),
        "cross": torch.zeros(R, dtype=torch.int64, device=dev),
        "sums": torch.zeros((R, 8), dtype=st["node_f"].dtype, device=dev),
        "bins": torch.zeros(meta["total_bins"], dtype=torch.int64, device=dev),
        "seen": torch.zeros((B, R), dtype=torch.bool, device=dev),
    }


def local_position(st, out):
    """Post-step position of each lane in its ``tnode``'s local frame
    (0 where there is no tnode)."""
    here = out["tnode"] >= 0
    R = st["node_f"][out["tnode"].clamp(min=0).long(), T.NF_W2L:T.NF_W2L + 12]
    px, py, pz = out["px"], out["py"], out["pz"]
    return [
        torch.where(here, R[:, 4 * k] * px + R[:, 4 * k + 1] * py
                    + R[:, 4 * k + 2] * pz + R[:, 4 * k + 3], 0.0)
        for k in range(3)
    ]


def tally(t, st, out, score=None, slack=None):
    """Add the events of one step (`out`, the dict of ``physics.step``
    with the post-step state) to tallies `t`, in place; with `score`
    [CH, B], the path scores of the photons' first matches to
    ``rec_scores``, and their `slack` to ``rec_slack``."""
    meta = st["meta"]
    if not meta["n_rec"]:
        return
    rec_i, rec_f = st["rec_i"], st["rec_f"]
    m = (out["tnode"][:, None] == rec_i[:, T.RI_NODE]) & (
        out["sel"][:, None] == rec_i[:, T.RI_EVENT]
    )
    facet = rec_i[:, T.RI_FACET] != 0
    fm = out["have_n"][:, None]
    for k, name in enumerate(("wnx", "wny", "wnz")):
        fm = fm & (torch.abs(out[name][:, None] - rec_f[:, T.RF_NX + k]) <= rec_f[:, T.RF_ATOL])
    m = m & (fm | ~facet)

    new = m & ~t["seen"]
    t["cross"] += m.sum(0)
    t["distinct"] += new.sum(0)
    t["seen"] |= m
    angle = torch.where(out["surface_event"], torch.arccos(out["c_in"]), 0.0)
    wav, trav, dur = out["wav"], out["trav"], out["dur"]
    props8 = torch.stack(
        [wav, wav * wav, angle, angle * angle, dur, dur * dur, trav, trav * trav], 1
    )
    t["sums"] += new.T.to(props8.dtype) @ props8
    if score is not None:
        newf = new.T.to(score.dtype)
        t["rec_scores"] += newf @ score.T
        t["rec_abs"] += newf @ score.abs().T
        if slack is not None:
            t["rec_slack"] += new.T.double() @ slack.T
        first = new.any(1)
        if bool(first.any()):
            t["score_max"] = torch.maximum(t["score_max"], score[:, first].abs().amax(1))
    if meta["total_bins"]:
        props = torch.stack([wav, angle, dur, trav, *local_position(st, out)], 1)
        hist_i, hist_f = st["hist_i"], st["hist_f"]
        n_a, n_b = hist_i[:, T.HI_NA], hist_i[:, T.HI_NB]
        one_d = hist_i[:, T.HI_PROP_B] < 0

        def index(prop, lo, width, n):
            v = props[:, prop.clamp(min=0).long()]
            f = torch.floor((v - lo) / width * n.to(v.dtype))
            ok = (f >= 0) & (f < n)
            return torch.where(ok, f, 0.0).long(), ok

        ia, ok_a = index(hist_i[:, T.HI_PROP_A], hist_f[:, T.HF_LO_A], hist_f[:, T.HF_W_A], n_a)
        ib, ok_b = index(hist_i[:, T.HI_PROP_B], hist_f[:, T.HF_LO_B], hist_f[:, T.HF_W_B], n_b)
        ib = torch.where(one_d, 0, ib)
        ok = ok_a & (ok_b | one_d) & new[:, hist_i[:, T.HI_REC].long()]
        flat = hist_i[:, T.HI_OFF] + ia * n_b + ib
        t["bins"] += torch.bincount(flat[ok], minlength=meta["total_bins"])


def reset_seen(t, lanes):
    """Forget the recorders lanes `lanes` have matched (they were refilled)."""
    t["seen"][lanes] = False
