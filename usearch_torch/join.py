"""`Index.join`: a one-to-one stable matching of two indexes' keys.

Counterpart of `usearch_tpu/join.py`. The smaller index proposes: its live
rows, decoded to f32, are searched in the other index in one batch (the
exact scan with ``exact=True``, the IVF's probes where one is built), and
each row's ``max_proposals`` results are its proposals, best first. Then
Gale-Shapley runs on the host, proposer-optimal: a key holds the closest
proposer so far and a displaced proposer tries its next proposal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .enums import ScalarKind


def join(men, women, max_proposals: int = 0, exact: bool = False) -> Dict[int, int]:
    """A mapping from ``men``'s keys to ``women``'s."""
    swapped = len(men) > len(women)
    if swapped:
        men, women = women, men
    n_men, n_women = len(men), len(women)
    if n_men == 0 or n_women == 0:
        return {}
    if max_proposals <= 0:
        max_proposals = int(min(n_women, max(16, int(np.ceil(np.log2(n_women + 1))) * 4)))

    # rows by live slot keep row i with key i (with multi keys `vectors`
    # would repeat a key's rows once per occurrence)
    live = men._live_slots()
    men_keys = np.asarray(men._slot_keys[live], dtype=np.uint64)
    matches = women.search(men._fetch_slots(live, ScalarKind.F32), max_proposals, exact=exact)
    proposal_keys, proposal_dists = matches.keys, matches.distances
    proposal_counts = matches.counts.astype(np.int64)

    engaged_to: Dict[int, int] = {}  # woman key -> man index
    engaged_dist: Dict[int, float] = {}
    next_proposal = np.zeros(n_men, dtype=np.int64)
    free = list(range(n_men))
    while free:
        man = free.pop()
        while next_proposal[man] < proposal_counts[man]:
            p = next_proposal[man]
            next_proposal[man] += 1
            woman = int(proposal_keys[man, p])
            dist = float(proposal_dists[man, p])
            current = engaged_to.get(woman)
            if current is None or dist < engaged_dist[woman]:
                engaged_to[woman] = man
                engaged_dist[woman] = dist
                if current is not None:
                    free.append(current)
                break

    result: Dict[int, int] = {}
    for woman, man in engaged_to.items():
        man_key = int(men_keys[man])
        if swapped:
            result[woman] = man_key
        else:
            result[man_key] = woman
    return result
