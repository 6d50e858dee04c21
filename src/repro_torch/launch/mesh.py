"""Elastic re-mesh plans over logical rank ids.

When the remediation ladder evicts a sick rank, the survivors get a new
dense rank assignment and the evicted rank's unfinished work is dealt to
them; when a replacement comes back, :meth:`RemeshPlan.splice_rank` claws
exactly the un-done share back.  Pure functions: nothing here touches a
device or a process group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["RemeshPlan", "plan_eviction"]


# -- elastic re-mesh (remediation rung 3) -----------------------------------------
#
# When the remediation ladder evicts a sick rank, the surviving ranks need a
# new dense rank assignment and the evicted rank's unfinished work needs new
# owners.  These helpers are pure functions over *logical* rank ids — the
# driver applies the plan by relaunching / re-configuring workers; nothing
# here touches a device.


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """Survivor topology after evicting ranks from a world of ``world_size``.

    ``survivors`` keeps original rank ids in order; ``dense_rank`` maps each
    survivor's original id to its new dense id (0..len(survivors)-1), which
    is what data-parallel sharding keys off after the re-mesh.
    """

    world_size: int
    evicted: Tuple[int, ...]
    survivors: Tuple[int, ...]
    dense_rank: Dict[int, int]

    def reassign(self, pending: Dict[int, int]) -> Dict[int, int]:
        """Fold evicted ranks' pending work onto the survivors.

        ``pending`` maps original rank id → count of unfinished work items
        (steps, shards...).  Survivors keep their own count; each evicted
        rank's count is dealt round-robin across survivors (orphan work is
        spread, not dumped on rank 0).  Returns original-survivor-id → new
        count; total work is conserved.
        """
        if not self.survivors:
            raise ValueError("no survivors to reassign work to")
        out = {r: int(pending.get(r, 0)) for r in self.survivors}
        orphans = sorted(
            (r, int(n)) for r, n in pending.items() if r in set(self.evicted)
        )
        i = 0
        for _, n in orphans:
            for _ in range(n):
                out[self.survivors[i % len(self.survivors)]] += 1
                i += 1
        return out

    def deal_shares(self, rank: int, remainder: int) -> Dict[int, int]:
        """How :meth:`reassign` would deal ``rank``'s ``remainder`` across
        the survivors: survivor id → share.  The record a driver must keep
        at eviction time so a later :meth:`splice_rank` can claw exactly the
        re-dealt work back (work conservation is an identity over these
        shares, not a re-derivation)."""
        if rank not in set(self.evicted):
            raise ValueError(f"rank {rank} is not evicted in this plan")
        shared = self.reassign({rank: int(remainder)})
        return {s: shared[s] for s in self.survivors if shared[s]}

    def splice_rank(
        self,
        rank: int,
        dealt: Dict[int, int],
        done_extra: Optional[Dict[int, int]] = None,
    ) -> Tuple["RemeshPlan", Dict[int, int]]:
        """Splice an evicted ``rank`` back into the mesh (its replacement).

        ``dealt`` is the share of the evicted rank's remainder each survivor
        was handed at eviction time (:meth:`deal_shares`); ``done_extra``
        is how much of that share each survivor has *already finished* —
        finished work is never clawed back.  Returns ``(new_plan,
        giveback)`` where ``giveback`` maps survivor id → steps returned to
        the replacement: ``max(0, dealt - done_extra)``.  The replacement
        takes back exactly the un-done remainder, so total work across the
        mesh is conserved through evict → splice regardless of how far each
        survivor got (the chaos harness asserts this identity end-to-end).
        """
        ev = set(self.evicted)
        if rank not in ev:
            raise ValueError(f"rank {rank} is not evicted in this plan")
        done = done_extra or {}
        giveback: Dict[int, int] = {}
        for s, share in dealt.items():
            if s not in self.dense_rank:
                raise ValueError(f"dealt share names non-survivor rank {s}")
            back = max(0, int(share) - int(done.get(s, 0)))
            if back:
                giveback[s] = back
        ev.discard(rank)
        surv = tuple(sorted(set(self.survivors) | {rank}))
        return (
            RemeshPlan(
                world_size=self.world_size,
                evicted=tuple(sorted(ev)),
                survivors=surv,
                dense_rank={r: i for i, r in enumerate(surv)},
            ),
            giveback,
        )


def plan_eviction(world_size: int, evicted: Iterable[int]) -> RemeshPlan:
    """Build the survivor re-mesh plan for evicting ``evicted`` ranks.

    Evicting every rank (or an unknown rank id) is a planning error and
    raises — the remediation engine's eviction budget should have stopped
    the ladder before the cluster ate itself.
    """
    ev = tuple(sorted(set(int(r) for r in evicted)))
    if any(r < 0 or r >= world_size for r in ev):
        raise ValueError(f"evicted ranks {ev} out of range for world_size={world_size}")
    surv = tuple(r for r in range(world_size) if r not in set(ev))
    if not surv:
        raise ValueError(f"cannot evict all {world_size} ranks")
    return RemeshPlan(
        world_size=world_size,
        evicted=ev,
        survivors=surv,
        dense_rank={r: i for i, r in enumerate(surv)},
    )
