"""Meshes over ``torch.distributed`` ranks, and elastic re-mesh plans.

A :class:`Mesh` names its axes and their sizes in order, as the JAX mesh's
``shape`` does.  Three kinds:

* a logical mesh (:func:`make_production_mesh`): sizes only, for the
  partitioner and the analytics; asking it for a group or an axis index
  raises;
* a local mesh over the live process group (:func:`make_local_mesh`): it
  wraps a ``torch.distributed.device_mesh.DeviceMesh`` and gives each named
  axis's process group and this rank's index on it; ranks are laid out row
  major over the axes;
* the one-rank mesh :func:`make_local_mesh` builds when no process group
  is up: every axis has size 1, so no collective runs.

When the remediation ladder evicts a sick rank, the survivors get a new
dense rank assignment and the evicted rank's unfinished work is dealt to
them; when a replacement comes back, :meth:`RemeshPlan.splice_rank` claws
exactly the un-done share back.  Pure functions: nothing there touches a
device or a process group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Mesh", "RemeshPlan", "describe", "join_torchrun_group", "leave_group", "make_local_mesh",
           "make_production_mesh", "plan_eviction"]


class Mesh:
    """Axis sizes by name, in order (``shape``), optionally backed by a
    ``DeviceMesh`` over the live process group."""

    def __init__(self, shape: Dict[str, int], device_mesh=None, logical: bool = False):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.device_mesh = device_mesh
        self.logical = logical

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def device_mesh_or_raise(self):
        if self.device_mesh is None:
            raise RuntimeError(f"mesh {describe(self)} has no process group behind it")
        return self.device_mesh

    def _check(self, axis: str) -> None:
        if self.logical:
            raise RuntimeError(f"mesh {describe(self)} is logical (sizes only): it has no axis {axis!r} to run on")
        if axis not in self.shape:
            raise KeyError(f"mesh {describe(self)} has no axis {axis!r}")

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._check(axis)
        return self.device_mesh_or_raise().get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        self._check(axis)
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def coords(self, rank: int) -> Dict[str, int]:
        """Global ``rank``'s index along each axis: ranks are laid out row
        major over the axes, as :func:`make_local_mesh` lays them out."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def __repr__(self) -> str:
        kind = "logical" if self.logical else ("device" if self.device_mesh is not None else "one-rank")
        return f"Mesh({describe(self)}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 chips per pod; 2 pods for the multi-pod dry run.  Sizes only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16}, logical=True)
    return Mesh({"data": 16, "model": 16}, logical=True)


def make_local_mesh(model_parallel: Optional[int] = None) -> Mesh:
    """``(world // mp, mp)`` over ``("data", "model")`` across the ranks of
    the live process group (one rank when none is up); raises when the
    world does not divide by ``model_parallel``, as the JAX package does."""
    import torch
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    mp = model_parallel or 1
    if n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    shape = {"data": n // mp, "model": mp}
    if not live:
        return Mesh(shape)
    from torch.distributed.device_mesh import DeviceMesh

    # the DeviceMesh's device type names where its groups' tensors live; a
    # gloo group carries every tensor through host memory
    kind = "cpu" if dist.get_backend() == "gloo" else "cuda"
    dm = DeviceMesh(kind, torch.arange(n).reshape(n // mp, mp), mesh_dim_names=("data", "model"))
    return Mesh(shape, dm)


def join_torchrun_group(device):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment), join its
    process group over ``gloo``, the backend that runs more than one rank
    on one card, and return this rank's device: ``cuda:LOCAL_RANK`` modulo
    the cards, or ``device`` when it is not a card.  Without ``torchrun``
    nothing is joined and ``device`` comes back as it was."""
    import torch
    import torch.distributed as dist

    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def leave_group() -> None:
    """Leave the group :func:`join_torchrun_group` joined, if it joined one."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and dist.is_initialized():
        dist.destroy_process_group()


def describe(mesh: Mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh.shape.items())


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
