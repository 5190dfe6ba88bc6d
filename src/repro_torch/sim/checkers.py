"""Guarantee checkers — the paper's theorems as executable per-event laws
(the port's own copy of the reference's ``sim/checkers.py``).

Each checker inspects one replayed membership event through the device
plane's own instruments (the engine's fused epoch diff, the store's sync
stats, the host ``lookup_k_trace`` candidate walk) and returns a list of
:class:`Violation` records — empty means the guarantee held exactly.

The laws, keyed to the paper:

* **minimal disruption** (paper Thm. VI.2 / §II): between two epochs
  separated by removals ``D`` and additions ``A``, a key moves **iff** its
  old bucket is in ``D`` (those MUST move) or its new bucket is in ``A``
  (monotonicity: joiners only steal, leavers only shed), and no key may
  land on a removed bucket.
* **balance** (paper Thm. VI.1 / §II): placements of a fixed probe batch
  are multinomial-uniform over working buckets — every bucket's count
  stays within ``tol_sigma`` binomial standard deviations (+ a small
  absolute slack) of the mean, and the normalized coefficient of variation
  (observed CV ÷ multinomial CV ``sqrt(w/n)``) is recorded.
* **replica stability** (the salted walk's disruption bound): a key's
  k-replica set may change on a removal only if the removed bucket
  appeared among its salted-walk *candidates* (``lookup_k_trace``) — the
  per-slot analogue of minimal disruption.
* **bounded-load cap** (Mirrokni et al., PAPERS.md): after an assignment
  no bucket exceeds ``cap``, and every returned bucket was below the cap.
* **degradation profile** (paper §VIII / Fig. 23–26): mean host lookup
  steps vs fraction removed; :func:`degradation_knee` locates the knee —
  the paper's worst-case story keeps Memento flat to ~70 % removed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Violation:
    """One broken guarantee at one replayed event."""

    event: int       # trace event index
    checker: str     # "minimal_disruption" | "balance" | ...
    detail: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[event {self.event}] {self.checker}: {self.detail}"


# ---------------------------------------------------------------------------
# minimal disruption / monotonicity (exact)
# ---------------------------------------------------------------------------

def check_minimal_disruption(event: int, old: np.ndarray, new: np.ndarray,
                             removed: set[int], added: set[int]) -> list[Violation]:
    """Exact per-event law over a probe batch's two-epoch placements.

    ``old``/``new`` are the engine diff's per-key buckets (k=1).  For a
    pure removal burst ``added`` is empty and the law collapses to the
    paper's minimal disruption: moved == {old ∈ removed}; for a pure
    addition it is monotonicity: moved ⊆ {new ∈ added}; a mixed burst
    composes both.
    """
    old = np.asarray(old).reshape(-1)
    new = np.asarray(new).reshape(-1)
    moved = old != new
    out: list[Violation] = []
    must_move = np.isin(old, sorted(removed)) if removed else np.zeros(len(old), bool)
    may_move = must_move | (np.isin(new, sorted(added)) if added
                            else np.zeros(len(old), bool))
    stranded = int((must_move & ~moved).sum())
    if stranded:
        out.append(Violation(event, "minimal_disruption",
                             f"{stranded} keys stayed on removed buckets"))
    extra = int((moved & ~may_move).sum())
    if extra:
        out.append(Violation(event, "minimal_disruption",
                             f"{extra} keys moved without their bucket "
                             "leaving or a joiner claiming them"))
    if removed:
        landed = int(np.isin(new, sorted(removed)).sum())
        if landed:
            out.append(Violation(event, "minimal_disruption",
                                 f"{landed} keys landed ON removed buckets"))
    return out


# ---------------------------------------------------------------------------
# balance (ε-of-uniform over a fixed probe batch)
# ---------------------------------------------------------------------------

def balance_profile(placements: np.ndarray, working: list[int] | np.ndarray
                    ) -> dict:
    """Per-bucket counts + normalized CV of a placement batch.

    ``cv_normalized`` divides the observed CV by the multinomial CV
    ``sqrt(w/n)`` — ≈ 1 is hash-noise-level balance (the normalization the
    repo's quality benchmark uses)."""
    working = np.asarray(sorted(working), dtype=np.int64)
    placements = np.asarray(placements).reshape(-1)
    counts = np.bincount(placements, minlength=int(working.max()) + 1)[working]
    n, w = len(placements), len(working)
    mean = n / w
    cv = float(counts.std() / mean) if mean else 0.0
    return {"counts": counts, "mean": mean,
            "cv_normalized": cv / float(np.sqrt(w / n)) if n else 0.0}


def check_balance(event: int, placements: np.ndarray,
                  working: list[int] | np.ndarray, *, tol_sigma: float = 6.0,
                  slack: int = 8, min_mean: float = 8.0) -> list[Violation]:
    """No working bucket holds more than ``mean + tol_sigma·√mean + slack``
    probe keys.  The binomial 6σ tail is ≈ 1e-9 per bucket, so on a correct
    algorithm this never fires; skipped when the probe batch is too small
    for the bound to mean anything (``mean < min_mean``)."""
    prof = balance_profile(placements, working)
    if prof["mean"] < min_mean:
        return []
    bound = prof["mean"] + tol_sigma * np.sqrt(prof["mean"]) + slack
    peak = int(prof["counts"].max())
    if peak > bound:
        return [Violation(event, "balance",
                          f"peak bucket holds {peak} keys > ε-bound "
                          f"{bound:.1f} (mean {prof['mean']:.1f}, "
                          f"cv_norm {prof['cv_normalized']:.2f})")]
    return []


# ---------------------------------------------------------------------------
# replica-set stability (bound via the candidate walk)
# ---------------------------------------------------------------------------

def candidate_hits(h, probe_keys: np.ndarray, k: int,
                   victims: set[int]) -> np.ndarray:
    """Which probe keys' salted-walk candidates include a victim bucket —
    computed on the PRE-event host state with the production instrument
    ``lookup_k_trace`` (``core/protocol.py``).  A superset mask of the keys whose
    replica set is allowed to change when ``victims`` are removed."""
    kk = min(k, h.working)
    hits = np.zeros(len(probe_keys), bool)
    for i, key in enumerate(np.asarray(probe_keys)):
        _, cands = h.lookup_k_trace(int(key), kk)
        hits[i] = any(c in victims for c in cands)
    return hits


def check_replica_stability(event: int, moved: np.ndarray,
                            hits: np.ndarray) -> list[Violation]:
    """Replica sets changed ⊆ keys whose candidate walk touched a victim."""
    moved = np.asarray(moved).astype(bool)
    rogue = int((moved & ~hits).sum())
    if rogue:
        return [Violation(event, "replica_stability",
                          f"{rogue} keys' replica sets changed although no "
                          "walk candidate touched a removed bucket")]
    return []


# ---------------------------------------------------------------------------
# follower convergence (cross-process replication)
# ---------------------------------------------------------------------------

def check_follower_convergence(event: int, leader_image,
                               followers) -> list[Violation]:
    """Eventual-epoch convergence: after a publish round, every follower's
    replicated image must sit at the leader's epoch with a bit-identical
    fingerprint (:func:`repro_torch.core.protocol.image_fingerprint` — every word
    a lookup can gather, capacity padding excluded).  Followers behind on
    epoch get an ``epoch lag`` violation; followers AT the epoch with
    different words get the (far worse) ``diverged`` one — a replication
    bug, not a lag."""
    from repro_torch.core.protocol import image_fingerprint

    want = image_fingerprint(leader_image)
    out: list[Violation] = []
    for idx, f in enumerate(followers):
        if f.epoch != leader_image.epoch:
            out.append(Violation(event, "follower_convergence",
                                 f"follower {idx} at epoch {f.epoch} != "
                                 f"leader {leader_image.epoch} (lag)"))
        elif f.fingerprint() != want:
            out.append(Violation(event, "follower_convergence",
                                 f"follower {idx} DIVERGED at epoch "
                                 f"{f.epoch}: {f.fingerprint()} != {want}"))
    return out


# ---------------------------------------------------------------------------
# bounded-load cap invariant
# ---------------------------------------------------------------------------

def check_cap_invariant(event: int, assignments: np.ndarray,
                        load: np.ndarray, cap: int) -> list[Violation]:
    out: list[Violation] = []
    load = np.asarray(load)
    over = int((load > cap).sum())
    if over:
        out.append(Violation(event, "cap_invariant",
                             f"{over} buckets exceed cap={cap} "
                             f"(peak {int(load.max())})"))
    if np.asarray(assignments).min(initial=0) < 0:
        out.append(Violation(event, "cap_invariant",
                             "unassigned keys left in the batch"))
    return out


# ---------------------------------------------------------------------------
# degradation profile (graceful-degradation knee)
# ---------------------------------------------------------------------------

def degradation_knee(profile: list[tuple[float, float]]) -> float | None:
    """Scale-free knee of a degradation profile: the checkpoint of maximum
    (normalized) deviation below the chord joining the profile's first and
    last points — the standard elbow locator for a convex cost curve.

    Memento's worst-case step count grows superlinearly in the removed
    fraction (E[τ]+E[σ] ~ ln(n/w) sweeps whose replacement chains also
    lengthen, paper Props. VII.1–3), so the curve stays near its cheap
    baseline and then turns hard upward; on the measured incremental
    profile the turn sits at ~0.65–0.7 removed — the paper's "graceful up
    to ~70 % failures" story (Figs. 23–26) as one executable number.
    Returns None when the profile is too short or never degrades."""
    if len(profile) < 3:
        return None
    f = np.asarray([p[0] for p in profile], float)
    s = np.asarray([p[1] for p in profile], float)
    if s[-1] <= s[0]:
        return None
    fn = (f - f[0]) / (f[-1] - f[0])       # normalize both axes so the
    sn = (s - s[0]) / (s[-1] - s[0])       # chord is y = x
    dev = fn - sn                          # convex curve ⇒ dev ≥ 0 at knee
    if dev.max() <= 0:
        return None
    return float(f[int(dev.argmax())])
