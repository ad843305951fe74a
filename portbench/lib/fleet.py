"""The paper's wearable fleet: its recordings from a seed, the program's
``StreamEngine`` built as the configuration states, one pass of a
backlog through it, and the comparison of what the engine scored with the
plain reference (``portbench/reference/fleet``).

A cough patient sends audio (2 ch, 16 kHz) and IMU (9 ch, 100 Hz) in
0.3 s windows, scored by ``cough_pipeline`` in the configuration's cough
format; an ECG patient sends 250 Hz ECG in 2 s windows, scored by
``rpeak_pipeline`` in the R-peak format with the per-patient tracker and
the router's escalation ladder.  Both sides score with the same forest,
trained here from the seed by the reference's CART on the reference's
features.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.lib import biosignals as bio
from portbench.reference.fleet import cough as ref_cough
from portbench.reference.fleet import rpeak as ref_rpeak

AUDIO_N = int(bio.AUDIO_SR * bio.WINDOW_S)      # 4800 samples a window
IMU_N = int(bio.IMU_SR * bio.WINDOW_S)          # 30
ECG_N = int(round(2.0 * bio.ECG_FS))            # 500


def seed_seq(seed: int, *tag: int) -> np.random.Generator:
    """A numpy generator from the run's seed (any size) and a tag."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 63), *tag]))


@dataclasses.dataclass
class Recordings:
    """Every patient's whole recording: cough audio (C, 2, W·4800) and IMU
    (C, 9, W·30); ECG (E, W·500)."""

    audio: np.ndarray
    imu: np.ndarray
    ecg: np.ndarray

    @property
    def n_cough(self) -> int:
        return self.audio.shape[0]

    @property
    def n_ecg(self) -> int:
        return self.ecg.shape[0]


def make_recordings(seed: int, n_cough: int, n_ecg: int, windows: int,
                    pool: int) -> Recordings:
    """Recordings drawn from the seed.  Cough events come from a pool of
    ``pool`` distinct windows (generated once; each patient's events are a
    seeded draw from it), ECG recordings each from their own seed."""
    rng = seed_seq(seed, 1)
    events = [bio.cough_window(rng) for _ in range(pool)]
    pa = np.stack([a for a, _, _ in events]).astype(np.float32)
    pi = np.stack([i for _, i, _ in events]).astype(np.float32)
    pick = rng.integers(0, pool, (n_cough, windows))
    audio = pa[pick].transpose(0, 2, 1, 3).reshape(n_cough, 2, -1)
    imu = pi[pick].transpose(0, 2, 1, 3).reshape(n_cough, 9, -1)
    ecg = np.stack([
        bio.ecg_stream_signal(windows * 2.0, int(s))[0]
        for s in rng.integers(0, 2 ** 31, n_ecg)]).astype(np.float32)
    return Recordings(np.ascontiguousarray(audio), np.ascontiguousarray(imu),
                      ecg)


def training_set(seed: int, n: int):
    """Labelled cough windows, disjoint from the traffic, for the forest."""
    audio, imu, labels = bio.cough_dataset(n, seed=int(
        seed_seq(seed, 2).integers(0, 2 ** 31)))
    return audio.astype(np.float32), imu.astype(np.float32), labels


def train_forest(cfg: Dict, seed: int, device) -> ref_cough.Trees:
    """The forest both sides score: CART in float64 on the reference's
    features (in the cough format) of a seeded training set."""
    f = cfg["forest"]
    audio, imu, labels = training_set(seed, f["train_windows"])
    ar = ref_cough.Arith.make(cfg["cough"]["format"])
    X = ref_cough.extract_features(
        ar, torch.as_tensor(audio, device=device),
        torch.as_tensor(imu, device=device))
    return ref_cough.train_trees(X.cpu().numpy().astype(np.float64), labels,
                                 f["trees"], f["depth"], seed % (1 << 32))


Chunk = Tuple[int, str, str, np.ndarray]   # (patient, task, modality, data)


def ragged_schedule(rec: Recordings, seed: int, chunks: Dict) -> List[Chunk]:
    """Every patient's recording cut into ragged chunks (per modality,
    lengths uniform in the cell's ranges) and interleaved across the
    fleet in a seeded order, each stream in order.  Patients 0..C-1 are
    cough, C..C+E-1 ECG."""
    rng = seed_seq(seed, 3)
    queues = []
    for p in range(rec.n_cough):
        queues.append([(p, "cough", "audio", c) for c in bio.ragged_chunks(
            rec.audio[p], rng, *chunks["audio"])])
        queues.append([(p, "cough", "imu", c) for c in bio.ragged_chunks(
            rec.imu[p], rng, *chunks["imu"])])
    for e in range(rec.n_ecg):
        queues.append([(rec.n_cough + e, "rpeak", "ecg", c)
                       for c in bio.ragged_chunks(rec.ecg[e][None, :], rng,
                                                  *chunks["ecg"])])
    out: List[Chunk] = []
    heads = [0] * len(queues)
    live = [q for q in range(len(queues)) if queues[q]]
    while live:
        k = int(rng.integers(len(live)))
        q = live[k]
        out.append(queues[q][heads[q]])
        heads[q] += 1
        if heads[q] == len(queues[q]):
            live.pop(k)
    return out


def build_engine(cfg: Dict, trees: ref_cough.Trees, max_batch: int, device):
    """The program's engine as the configuration states it."""
    from repro_torch.apps.forest import forest_from_arrays
    from repro_torch.stream import (EscalationPolicy, PrecisionRouter,
                                    StreamEngine, cough_pipeline,
                                    rpeak_pipeline)
    esc = cfg["escalation"]
    router = PrecisionRouter(
        task_formats={"cough": cfg["cough"]["format"],
                      "rpeak": cfg["rpeak"]["format"]},
        escalation=EscalationPolicy(
            ladder=tuple(esc["ladder"]), margin=esc["margin"],
            hold_windows=esc["hold_windows"], hysteresis=esc["hysteresis"]))
    forest = forest_from_arrays(trees.feat, trees.thresh, trees.value,
                                trees.depth)
    return StreamEngine({"cough": cough_pipeline(forest),
                         "rpeak": rpeak_pipeline()},
                        router=router, max_batch=max_batch,
                        result_capacity=None, device=device)


def pid(tag: str, p: int, rec: Recordings) -> str:
    if p < rec.n_cough:
        return f"{tag}-cough-{p:05d}"
    return f"{tag}-ecg-{p - rec.n_cough:05d}"


@dataclasses.dataclass
class Answer:
    """What the engine gave one sampled patient: per window (in widx
    order) its format, its batch's completion stamp and its outputs; the
    tracker's final flush."""

    widx: List[int]
    fmt: List[str]
    done: List[float]
    out: List[Dict[str, np.ndarray]]
    tail: Optional[np.ndarray] = None


def collect(results, wanted: Dict[str, int]) -> Dict[int, Answer]:
    """The sampled patients' answers from a pass's results."""
    got: Dict[int, Dict[int, object]] = {}
    for r in results:
        p = wanted.get(r.patient)
        if p is not None:
            got.setdefault(p, {})[r.widx] = r
    out = {}
    for name, p in wanted.items():
        rows = got.get(p, {})
        ws = [rows[w] for w in sorted(rows)]
        out[p] = Answer([r.widx for r in ws], [r.fmt for r in ws],
                        [r.done_wall for r in ws],
                        [{k: np.array(v) for k, v in r.outputs.items()}
                         for r in ws])
    return out


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def dispatch_groups(done: List[float]) -> List[List[int]]:
    """Consecutive windows with one completion stamp went out together."""
    groups: List[List[int]] = []
    for w, t in enumerate(done):
        if groups and done[groups[-1][-1]] == t:
            groups[-1].append(w)
        else:
            groups.append([w])
    return groups


def reference_cough(cfg: Dict, trees, rec: Recordings, patients: List[int],
                    fmt: str, device, block: int = 256) -> Dict[int, np.ndarray]:
    """P(cough) of every window of ``patients``, in ``fmt``, in blocks."""
    W = rec.audio.shape[-1] // AUDIO_N
    a = rec.audio[patients].reshape(len(patients), 2, W, AUDIO_N)
    a = a.transpose(0, 2, 1, 3).reshape(-1, 2, AUDIO_N)
    i = rec.imu[patients].reshape(len(patients), 9, W, IMU_N)
    i = i.transpose(0, 2, 1, 3).reshape(-1, 9, IMU_N)
    ps = []
    for s in range(0, a.shape[0], block):
        ps.append(ref_cough.cough_scores(
            fmt, trees, torch.as_tensor(a[s:s + block], device=device),
            torch.as_tensor(i[s:s + block], device=device)).cpu().numpy())
    ps = np.concatenate(ps).reshape(len(patients), W)
    return {p: ps[k] for k, p in enumerate(patients)}


def reference_ecg_scores(rec: Recordings, patients: List[int], fmts,
                         device) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{fmt: (scores (P, W, 500), counts (P, W))} for the ECG patients
    (indices into ``rec.ecg``)."""
    x = rec.ecg[patients].reshape(len(patients), -1, ECG_N)
    P, W, _ = x.shape
    xt = torch.as_tensor(x.reshape(P * W, ECG_N), device=device)
    out = {}
    for fmt in fmts:
        s = ref_rpeak.window_scores(fmt, xt)
        c = ref_rpeak.peak_counts(s)
        out[fmt] = (s.cpu().numpy().reshape(P, W, ECG_N),
                    c.cpu().numpy().reshape(P, W))
    return out


def compare(cfg: Dict, trees, rec: Recordings,
            answers: List[Dict[int, Answer]], windows: Optional[int], device,
            cough_fmt: Optional[str] = None,
            ecg_base: Optional[str] = None) -> Dict[str, float]:
    """The numbers that decide ``correct``, over every sampled answer.
    ``windows`` is how many windows each sampled patient was due (None:
    those its answer holds, which must run 0, 1, ... without a gap).
    ``cough_fmt``/``ecg_base`` put the reference in another precision
    (the control): the reference then stands in the program's place, and
    its own route replaces the program's formats."""
    control = cough_fmt is not None
    ladder_cfg = cfg["escalation"]
    ladder = ref_rpeak.Ladder(tuple(ladder_cfg["ladder"]),
                              ladder_cfg["margin"],
                              ladder_cfg["hold_windows"],
                              ladder_cfg["hysteresis"])
    base = cfg["rpeak"]["format"]
    cough_ps = sorted({p for a in answers for p in a if p < rec.n_cough})
    ecg_ps = sorted({p for a in answers for p in a if p >= rec.n_cough})
    ref_p = reference_cough(cfg, trees, rec, cough_ps,
                            cfg["cough"]["format"], device)
    ctl_p = (reference_cough(cfg, trees, rec, cough_ps, cough_fmt, device)
             if control else None)
    fmts = sorted(set(ladder.rungs) | {base, ecg_base or base})
    ecg_idx = [p - rec.n_cough for p in ecg_ps]
    table = reference_ecg_scores(rec, ecg_idx, fmts, device)
    res = {"missing_windows": 0.0, "cough_p_max_abs": 0.0,
           "rpeak_score_max_abs": 0.0, "rpeak_count_mismatch": 0.0,
           "route_mismatch": 0.0, "peaks_mismatch_share": 0.0}
    peaks_bad = peaks_all = 0
    for ans in answers:
        for p, a in ans.items():
            n = len(a.out)
            due = n if windows is None else windows
            res["missing_windows"] += due - n + sum(
                w != i for i, w in enumerate(a.widx))
            if not n or n != due or a.widx != list(range(n)):
                continue
            if p < rec.n_cough:
                got = (ctl_p[p][:n] if control else
                       np.asarray([o["p_cough"] for o in a.out], np.float64))
                res["cough_p_max_abs"] = max(res["cough_p_max_abs"], float(
                    np.max(np.abs(got - ref_p[p][:n]))))
                continue
            k = ecg_ps.index(p)
            by_fmt = {f: table[f][0][k][:n] for f in fmts}
            cnt = {f: table[f][1][k][:n] for f in fmts}
            groups = dispatch_groups(a.done)
            ref = ref_rpeak.replay_patient(by_fmt, cnt, base, ladder,
                                           groups, used=a.fmt)
            if control:
                got = ref_rpeak.replay_patient(by_fmt, cnt, ecg_base,
                                               ladder, groups)
                g_scores, g_count, g_fmt = (got["scores"], got["count"],
                                            got["fmt"])
                g_peaks = got["peaks"]
            else:
                g_scores = np.stack([o["scores"] for o in a.out])
                g_count = np.asarray([int(o["peak_count"]) for o in a.out])
                g_fmt = a.fmt
                g_peaks = [int(q) for o in a.out for q in o["peaks"]]
                g_peaks += [int(q) for q in (a.tail if a.tail is not None
                                             else [])]
            res["rpeak_score_max_abs"] = max(
                res["rpeak_score_max_abs"], float(np.nanmax(np.abs(
                    g_scores.astype(np.float64) - ref["scores"]))))
            res["rpeak_count_mismatch"] += float(np.sum(
                g_count != ref["count"]))
            res["route_mismatch"] += float(sum(
                f != r for f, r in zip(g_fmt, ref["route"])))
            want = set(ref["peaks"])
            peaks_bad += len(want.symmetric_difference(g_peaks))
            peaks_all += max(len(want), 1)
    res["peaks_mismatch_share"] = peaks_bad / max(peaks_all, 1)
    return res
