"""Mixture-of-Experts LM (moonshot 64 experts / top-6, kimi-k2 384 / top-8):
training forward and serving path.

The block is the dense family's (``transformer.block`` in training,
attention by ``layers.attend_cfg`` and no kernel; ``prefill_layer`` /
``decode_layer`` in serving, every prefill attention through the flash
kernel) with the MLP replaced by the expert layer.  On one device the JAX
package's ``moe_ffn`` takes ``_moe_dense``: every expert on every token and
a masked combine of the router's top-k.  The port computes that function.
The expert products are batched matmuls over the expert axis whose token
operand is the tokens broadcast as a view, so nothing copies the
``[E, d, f]`` weights (an einsum over ``"td,edf->tef"`` copies); under
autograd the view's gradient is summed from ``[E, T, d]``.  The combine is a
scatter of the top-k weights into a ``[T, E]`` matrix, with static shapes
and no host sync, so the decode step captures as a CUDA graph.  The
router's expert shares (a scatter of ones) carry no gradient, as the JAX
one-hot carries none; the mean probabilities and the top-k weights do.

``forward_train`` returns the logits and the load-balance loss averaged
over the layers, summed in fp32 from an fp32 zero as the JAX scan's carry.
MoE configs have no sliding window, so the dense block's window is None.

Over a mesh whose "model" axis has ep > 1 ranks, ``moe_ffn`` runs the JAX
package's expert-parallel paths, each rank holding ``E/ep`` experts and
the collectives written out (``sharding.collectives``, where JAX writes
``shard_map`` with ``lax.all_to_all`` / ``psum``): ``_moe_ep_seq`` for
prefill and training (this rank's ``S/ep`` slice of the sequence grouped
by destination shard, ``all_to_all`` there and back, an ``all_gather``
rebuilding the sequence), ``_moe_ep_replicated`` for decode (local experts
and a psum) and ``_moe_ep_2d`` when the config serves 2-D (the expert FFN
dimension over the data axes too).  Grouping sorts stably and gives each
assignment a slot of a ``[groups, capacity]`` buffer; the sentinel group
and rows past capacity go to one dump slot that is cut away, so exactly
the assignments that the JAX package's out-of-bounds scatter drops are
dropped (``kept_assignments`` says which, for a caller that counts them).
The aux term is each shard's estimate under a mean over every axis, as in
JAX.  A "model" axis over 1 on a mesh with no process group raises.
Around the expert layer the block's attention, embedding and unembedding
are the dense family's, on this rank's heads and vocabulary where those
leaves are split (``transformer``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C
from repro_torch.sharding.partition import DATA_AXES, PartitionSpec
from repro_torch.sharding.placement import take

from . import transformer
from .config import ModelConfig
from .layers import (
    apply_norm,
    attn_specs,
    embed,
    embed_specs,
    kv_cache_specs,
    layer_slices,
    norm_spec,
    unembed,
)
from .param import Spec


def specs(cfg: ModelConfig) -> dict:
    L, d, E, ffe = cfg.num_layers, cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    return {
        "embed": embed_specs(cfg),
        "blocks": {
            "attn": attn_specs(cfg, stacked=L),
            "router": Spec((L, d, E), ("layers", "embed", None)),
            "w_gate": Spec((L, E, d, ffe), ("layers", "experts", "embed", "expert_mlp")),
            "w_up": Spec((L, E, d, ffe), ("layers", "experts", "embed", "expert_mlp")),
            "w_down": Spec((L, E, ffe, d), ("layers", "experts", "expert_mlp", "embed")),
            "ln1": norm_spec(cfg, stacked=L),
            "ln2": norm_spec(cfg, stacked=L),
        },
        "ln_f": norm_spec(cfg),
    }


def _router(cfg: ModelConfig, wr: torch.Tensor, xt: torch.Tensor, mesh=None, data_axes=()):
    """Returns (weights [T,k] in x's dtype, expert ids [T,k], aux loss): an
    fp32 softmax over the experts, its top-k renormalised, and the switch
    load-balance loss E·Σ_e (share of assignments)·(mean probability).
    With ``data_axes`` the share and the mean probability are means over
    those ranks' tokens too (equal shards), the estimate over the whole
    batch that the JAX package's one-"model"-rank path computes."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.softmax(xt.float() @ wr.float(), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    ones = torch.ones(idx.numel(), dtype=torch.float32, device=xt.device)
    share = torch.zeros(E, dtype=torch.float32, device=xt.device).scatter_add_(0, idx.reshape(-1), ones)
    share, mean_p = share / xt.shape[0], probs.mean(dim=0)
    if data_axes:
        share, mean_p = C.pmean(share, mesh, data_axes), C.pmean(mean_p, mesh, data_axes)
    aux = E * torch.sum(share * mean_p)
    return vals.to(xt.dtype), idx, aux


def _moe_dense(cfg: ModelConfig, p: dict, xt: torch.Tensor, mesh=None):
    """Every expert on every token, masked combine: ``[T, d]`` and the aux
    loss (over every data shard's tokens on a ``mesh``)."""
    E = cfg.moe.num_experts
    T, d = xt.shape
    data_axes = () if mesh is None else tuple(a for a in DATA_AXES if a in mesh.shape)
    w, idx, aux = _router(cfg, p["router"], xt, mesh, data_axes)
    xe = xt.expand(E, T, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])  # [E, T, f]
    y_all = torch.bmm(h, p["w_down"])  # [E, T, d]
    combine = torch.zeros((T, E), dtype=xt.dtype, device=xt.device).scatter_add_(1, idx, w)
    return torch.bmm(combine[:, None, :], y_all.transpose(0, 1))[:, 0], aux


# ---------------------------------------------------------------------------
# Sort-based token grouping (static shapes; overflow drops, standard capacity)
# ---------------------------------------------------------------------------

def _slots(eid: torch.Tensor, n_groups: int, capacity: int):
    """The stable sort of the group ids and each sorted row's slot: (order,
    eid sorted, position in its group, flat slot; a row of the sentinel
    group ``n_groups`` or at ``pos >= capacity`` gets the dump slot
    ``n_groups * capacity``, which the JAX package's out-of-bounds scatter
    drops)."""
    A = eid.shape[0]
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    seg_start = torch.searchsorted(eid_s, torch.arange(n_groups, device=eid.device, dtype=eid_s.dtype))
    pos = torch.arange(A, device=eid.device) - seg_start[torch.clamp(eid_s, 0, n_groups - 1)]
    valid = (eid_s < n_groups) & (pos < capacity)
    flat = torch.where(valid, eid_s * capacity + pos, n_groups * capacity)
    return order, eid_s, pos, flat, valid


def group_tokens(xt, eid, tok, n_groups: int, capacity: int):
    """Group assignment rows into a ``[n_groups, capacity, d]`` buffer.

    ``eid`` may hold the sentinel ``n_groups`` for invalid assignments: they
    sort last and are dropped, as is every row past a group's capacity.
    Returns (buffer, eid sorted, flat slot per sorted row, order, token per
    sorted row): what ``ungroup_tokens`` needs."""
    order, eid_s, pos, flat, _ = _slots(eid, n_groups, capacity)
    tok_s = tok[order]
    d = xt.shape[-1]
    buf = torch.zeros((n_groups * capacity + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_add(0, flat, xt[tok_s])
    return buf[:-1].reshape(n_groups, capacity, d), eid_s, flat, order, tok_s


def _rows_of(y: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Row ``flat`` of the grouped ``y`` for each sorted assignment, zeros
    for a dropped one (``get(mode="fill", fill_value=0)``)."""
    yf = y.reshape(-1, y.shape[-1])
    yf = torch.cat([yf, yf.new_zeros((1, yf.shape[-1]))])
    return yf.index_select(0, flat)


def ungroup_tokens(y, flat, n_tokens: int, tok_s, weights_s):
    """Inverse of ``group_tokens`` + weighted combine into ``[n_tokens, d]``."""
    ya = _rows_of(y, flat)
    out = torch.zeros((n_tokens, y.shape[-1]), dtype=y.dtype, device=y.device)
    return out.index_add(0, tok_s, ya * weights_s[:, None])


def expert_ffn(buf, w_gate, w_up, w_down):
    """Grouped GEMMs: ``[E, C, d] × [E, d, f]``, the SwiGLU per expert."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _capacity(T: int, cfg: ModelConfig, ep: int) -> int:
    """An expert shard's capacity on the decode paths: its expected load."""
    return max(int(math.ceil(T * cfg.moe.top_k * cfg.moe.capacity_factor / ep)), 4)


def _seq_capacity(T: int, cfg: ModelConfig, ep: int) -> int:
    """The sequence path's slots a destination shard, rounded up to 4."""
    return _round_up(_capacity(T, cfg, ep), 4)


def _expert_capacity(R: int, cfg: ModelConfig, E_loc: int) -> int:
    """The sequence path's slots a local expert for ``R`` received rows."""
    return _round_up(max(int(math.ceil(R * cfg.moe.capacity_factor / E_loc)), 4), 4)


# ---------------------------------------------------------------------------
# Dispatch paths
# ---------------------------------------------------------------------------


def _whole(p: dict, mesh) -> dict:
    return {k: take(v, PartitionSpec(), mesh) for k, v in p.items()}


def _local_expert_compute(cfg, p_local, xt, w, idx, ep: int, my_shard: int, capacity: int):
    """Group the tokens routed to this shard's experts, run them, combine:
    ``[T, d]``."""
    E_loc = cfg.moe.num_experts // ep
    T, k = idx.shape
    a_tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    a_w = w.reshape(-1)
    mine, loc_eid = _mine(idx, E_loc, my_shard)
    buf, eid_s, flat, order, tok_s = group_tokens(xt, loc_eid, a_tok, E_loc, capacity)
    y = expert_ffn(buf, p_local["w_gate"], p_local["w_up"], p_local["w_down"])
    w_s = torch.where(mine, a_w, torch.zeros_like(a_w))[order]
    return ungroup_tokens(y, flat, T, tok_s, w_s)


def _mine(idx: torch.Tensor, E_loc: int, my_shard: int):
    """(which assignments go to this shard's experts, their local expert
    ids with the sentinel ``E_loc`` for the others)."""
    a_eid = idx.reshape(-1)
    mine = torch.div(a_eid, E_loc, rounding_mode="floor") == my_shard
    return mine, torch.where(mine, a_eid % E_loc, E_loc)


def _ep_weights(p: dict, mesh, expert_mlp_axes=()) -> dict:
    """This rank's expert weights: experts over "model", the expert FFN
    dimension over ``expert_mlp_axes`` (the 2-D path's data axes)."""
    f = tuple(expert_mlp_axes) or None
    return {
        "w_gate": take(p["w_gate"], PartitionSpec("model", None, f), mesh),
        "w_up": take(p["w_up"], PartitionSpec("model", None, f), mesh),
        "w_down": take(p["w_down"], PartitionSpec("model", f), mesh),
    }


def _moe_ep_replicated(cfg: ModelConfig, p: dict, x, mesh, dp_axes):
    """Decode path: x replicated over "model"; local experts + psum combine."""
    Bl, S, d = x.shape
    ep = mesh.shape["model"]
    T = Bl * S
    xt = x.reshape(T, d)
    wr, idx, aux = _router(cfg, take(p["router"], PartitionSpec(), mesh), xt)
    my = C.axis_index(mesh, "model")
    out = _local_expert_compute(cfg, _ep_weights(p, mesh), xt, wr, idx, ep, my, _capacity(T, cfg, ep))
    out = C.psum(out, mesh, "model")
    aux = C.pmean(aux, mesh, mesh.axis_names)
    return out.reshape(Bl, S, d), aux


def _moe_ep_2d(cfg: ModelConfig, p: dict, x, mesh, dp_axes):
    """Resident 2-D expert sharding for decode: experts over "model" × the
    expert FFN dimension over the data axes, nothing re-gathered per step.
    The tokens are all-gathered over the data axes, each (data, model)
    shard computes its expert slice's partial FFN, and one psum over the
    whole mesh combines the experts (model) and the FFN partials (data)."""
    Bl, S, d = x.shape
    ep = mesh.shape["model"]
    xt, rows = _gathered(x, mesh, dp_axes)
    T = xt.shape[0]
    wr, idx, aux = _router(cfg, take(p["router"], PartitionSpec(), mesh), xt)
    my = C.axis_index(mesh, "model")
    out_all = _local_expert_compute(cfg, _ep_weights(p, mesh, dp_axes), xt, wr, idx, ep, my, _capacity(T, cfg, ep))
    out_all = C.psum(out_all, mesh, ("model",) + tuple(dp_axes))
    out = out_all[rows]
    aux = C.pmean(aux, mesh, mesh.axis_names)
    return out.reshape(Bl, S, d), aux


def _gathered(x, mesh, dp_axes):
    """The 2-D path's tokens: every data shard's rows ``[T, d]``, and this
    rank's rows among them."""
    Bl, S, d = x.shape
    xg = x
    for a in dp_axes:
        xg = C.all_gather(xg, mesh, a, dim=0)
    flat_idx = 0
    for a in dp_axes:
        flat_idx = flat_idx * mesh.shape[a] + C.axis_index(mesh, a)
    return xg.reshape(-1, d), slice(flat_idx * Bl * S, (flat_idx + 1) * Bl * S)


def _seq_slice(x, mesh):
    """The sequence path's tokens: this rank's ``S/ep`` slice ``[T, d]``."""
    Bl, S, d = x.shape
    Sl = S // mesh.shape["model"]
    my = C.axis_index(mesh, "model")
    return x[:, my * Sl : (my + 1) * Sl].reshape(-1, d)


def _eid_payload(idx: torch.Tensor, flat, order, E_loc: int, ep: int, cap_send: int) -> torch.Tensor:
    """``[ep, cap_send]``: the local expert id of each send slot's
    assignment (the sentinel ``E_loc`` marks an empty one)."""
    out = torch.full((ep * cap_send + 1,), E_loc, dtype=torch.int32, device=idx.device)
    out[flat] = (idx.reshape(-1) % E_loc)[order].to(torch.int32)
    return out[:-1].reshape(ep, cap_send)


def _moe_ep_seq(cfg: ModelConfig, p: dict, x, mesh, dp_axes):
    """Train / prefill path: this rank's ``S/ep`` slice of the sequence is
    grouped by destination shard, sent with an ``all_to_all``, grouped by
    local expert and run there, sent back and combined; an ``all_gather``
    over "model" rebuilds the whole sequence."""
    Bl, S, d = x.shape
    ep = mesh.shape["model"]
    E_loc = cfg.moe.num_experts // ep
    k = cfg.moe.top_k
    Sl = S // ep
    xt = _seq_slice(x, mesh)
    T = xt.shape[0]
    wr, idx, aux = _router(cfg, take(p["router"], PartitionSpec(), mesh), xt)
    # --- send-side grouping by destination shard ---------------------------
    a_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    a_w = wr.reshape(-1)
    dst = torch.div(idx.reshape(-1), E_loc, rounding_mode="floor")
    cap_send = _seq_capacity(T, cfg, ep)
    buf, dst_s, flat, order, tok_s = group_tokens(xt, dst, a_tok, ep, cap_send)
    eid_payload = _eid_payload(idx, flat, order, E_loc, ep, cap_send)
    # --- dispatch all_to_all -------------------------------------------------
    recv = C.all_to_all(buf, mesh, "model")
    recv_eid = C.all_to_all(eid_payload, mesh, "model")
    R = ep * cap_send
    rt = recv.reshape(R, d)
    re = recv_eid.reshape(R).long()
    # --- local expert grouping + FFN ----------------------------------------
    cap_e = _expert_capacity(R, cfg, E_loc)
    w = _ep_weights(p, mesh)
    gbuf, _, flat2, _, tok_s2 = group_tokens(rt, re, torch.arange(R, device=x.device), E_loc, cap_e)
    y = expert_ffn(gbuf, w["w_gate"], w["w_up"], w["w_down"])
    yr = torch.zeros((R, d), dtype=x.dtype, device=x.device).index_add(0, tok_s2, _rows_of(y, flat2))
    # --- return all_to_all + source-side combine -----------------------------
    back = C.all_to_all(yr.reshape(ep, cap_send, d), mesh, "model")
    out = ungroup_tokens(back, flat, T, tok_s, a_w[order])
    aux = C.pmean(aux, mesh, mesh.axis_names)
    out = C.all_gather(out.reshape(Bl, Sl, d), mesh, "model", dim=1)
    return out, aux


def _path(cfg: ModelConfig, x: torch.Tensor, mesh) -> str:
    """The dispatch path ``moe_ffn`` takes: "dense", "seq", "2d" or
    "replicated"."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return "dense"
    ep = mesh.shape["model"]
    if x.shape[1] % ep == 0 and x.shape[1] >= ep:
        return "seq"
    return "2d" if cfg.serve_2d else "replicated"


def kept_assignments(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Which of this rank's routed assignments ``moe_ffn(cfg, p, x, mesh)``
    sends to an expert and which its capacities drop: ``[T, k]`` bool over
    the tokens this rank routes (the sequence path: its ``S/ep`` slice; the
    2-D path: its own rows of the gathered tokens).  The path's routing and
    slotting again, without the expert FFN: a shard's drops are psummed over
    "model" on the decode paths, and the sequence path sends each
    receiver's verdict on its slots back with an ``all_to_all``."""
    k = cfg.moe.top_k
    path = _path(cfg, x, mesh)
    if path == "dense":
        return torch.ones((x.shape[0] * x.shape[1], k), dtype=torch.bool, device=x.device)
    ep = mesh.shape["model"]
    E_loc = cfg.moe.num_experts // ep
    dp_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    wr = take(p["router"], PartitionSpec(), mesh)
    if path == "seq":
        xt = _seq_slice(x, mesh)
        T = xt.shape[0]
        _, idx, _ = _router(cfg, wr, xt)
        cap_send = _seq_capacity(T, cfg, ep)
        order, _, _, flat, _ = _slots(torch.div(idx.reshape(-1), E_loc, rounding_mode="floor"), ep, cap_send)
        R = ep * cap_send
        re = C.all_to_all(_eid_payload(idx, flat, order, E_loc, ep, cap_send), mesh, "model").reshape(R).long()
        cap_e = _expert_capacity(R, cfg, E_loc)
        order2, _, _, flat2, _ = _slots(re, E_loc, cap_e)
        got = torch.zeros(R, dtype=torch.int32, device=x.device)
        got[order2] = (flat2 < E_loc * cap_e).to(torch.int32)
        back = C.all_to_all(got.reshape(ep, cap_send), mesh, "model").reshape(-1)
        back = torch.cat([back, back.new_zeros(1)])
        kept = torch.zeros(T * k, dtype=torch.bool, device=x.device)
        kept[order] = back[flat].bool()
        return kept.reshape(T, k)
    if path == "2d":
        xt, rows = _gathered(x, mesh, dp_axes)
    else:
        xt, rows = x.reshape(-1, x.shape[-1]), slice(None)
    T = xt.shape[0]
    _, idx, _ = _router(cfg, wr, xt)
    cap = _capacity(T, cfg, ep)
    mine, loc_eid = _mine(idx, E_loc, C.axis_index(mesh, "model"))
    order, _, _, flat, _ = _slots(loc_eid, E_loc, cap)
    # each assignment is dropped at most by the shard that owns its expert
    dropped = torch.zeros(T * k, dtype=torch.int32, device=x.device)
    dropped[order] = (mine[order] & (flat == E_loc * cap)).to(torch.int32)
    return (C.psum(dropped, mesh, "model") == 0).reshape(T, k)[rows]


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh=None):
    """Dispatch to the path for (mesh, sequence length), as the JAX
    ``moe_ffn``: dense without a mesh or with one "model" rank (its aux then
    the estimate over every data shard's tokens, as GSPMD computes it); the
    sequence path when ``S`` divides over "model"; the 2-D path when the
    config serves 2-D; otherwise the replicated path.  ``x`` is this rank's
    rows (its data shard), whole along the sequence."""
    path = _path(cfg, x, mesh)
    if path == "dense":
        B, S, d = x.shape
        out, aux = _moe_dense(cfg, _whole(p, mesh), x.reshape(-1, d), mesh)
        return out.reshape(B, S, d), aux
    if mesh.logical:
        raise RuntimeError(f"moe_ffn on mesh {mesh!r}: a model axis of "
                           f"{mesh.shape['model']} needs a live process group")
    ep = mesh.shape["model"]
    dp_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    if cfg.moe.num_experts % ep != 0:
        raise ValueError(f"{cfg.moe.num_experts} experts not divisible by ep={ep}")
    return {"seq": _moe_ep_seq, "2d": _moe_ep_2d, "replicated": _moe_ep_replicated}[path](cfg, p, x, mesh, dp_axes)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _ffn(mesh):
    """The expert layer as the dense block's feed-forward ``(cfg, p, h)``;
    ``moe_ffn`` is looked up at each call."""
    if mesh is None:
        return lambda c, p, h: moe_ffn(c, p, h)
    return lambda c, p, h: moe_ffn(c, p, h, mesh)


def _moe_mlp(cfg: ModelConfig, pl: dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    return _ffn(mesh)(cfg, pl, h)[0]


def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, mesh=None):
    """The dense training block with the expert layer: (x, aux)."""
    return transformer.block(cfg, p, x, positions, ffn=_ffn(mesh), mesh=mesh)


def forward_train(cfg: ModelConfig, params: dict, batch: dict, mesh=None):
    """(logits ``[B, S, padded_vocab]`` (this rank's vocabulary columns on a
    ``mesh``), the layers' mean load-balance loss)."""
    x = embed(params["embed"], batch["tokens"], cfg, mesh)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = transformer._remat(cfg, lambda pl, h: block(cfg, pl, h, positions, mesh))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pl in layer_slices(params["blocks"], cfg.num_layers):
        x, a = body(pl, x)
        aux = aux + a
    x = apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params["embed"], x), aux / cfg.num_layers


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    return kv_cache_specs(cfg, batch, cache_len, cfg.num_layers)


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int, mesh=None):
    """Run the prompt; returns last-position logits and a filled KV cache."""
    mlp = _moe_mlp if mesh is None else functools.partial(_moe_mlp, mesh=mesh)
    return transformer.prefill(cfg, params, batch, cache_len, mlp=mlp, mesh=mesh)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict, mesh=None):
    """One new token; writes the cache it is handed in place and returns it."""
    mlp = _moe_mlp if mesh is None else functools.partial(_moe_mlp, mesh=mesh)
    return transformer.decode_step(cfg, params, cache, batch, mlp=mlp, mesh=mesh)
