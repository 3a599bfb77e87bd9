"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): GShard
capacity routing of each token to its top-K experts, and an optional
shared expert.

  moe_specs(cfg, damp)   the layer's ParamSpecs (the router float32)
  route(p, x2, cfg)      the routing both versions share: fp32 logits,
                         softmax, top-K, renormalised gates
  moe_ffn_ref(p, x, cfg, mi)
                         the plain version: the reference's one-hot
                         dispatch and combine einsums, line for line
  moe_ffn(p, x, cfg, mi) the main path: the same function by index
                         dispatch, with no (T, E, C) tensor
  aux_load_balance_loss(p, x, cfg)
                         the Switch-style load-balancing loss (nothing in
                         the reference's forward_train calls it)

The reference's semantics, held exactly. The T = B*S tokens, in flattened
(B, S) order, fall into ``G = _n_groups(T, mi)`` consecutive groups of Tg =
T / G tokens: G = gcd(T, the mesh's size), 1 without a mesh. Each group
routes on its own:

* ``capacity = max(ceil(Tg*K/E*capacity_factor), 1)``. Every
  position routes and takes capacity: a right-padded prefill's padding,
  the engine's padding rows and its idle decode slots too, so the batch's
  make-up changes which choices a real token keeps, as in the reference.
* Logits in fp32 (x cast, the router float32), softmax, then top-K with
  ties to the lower expert index (``jax.lax.top_k``'s order).
* The gates are renormalised by ``max(sum, 1e-9)`` BEFORE the capacity
  drop; a dropped choice's gate becomes 0 and the kept gates are not
  renormalised again.
* A choice's position in its expert's buffer (of its group) is
  choice-major: every token's first choice comes before any second
  choice, tokens in order; a choice at position >= capacity is dropped.
* The gate is cast to x's dtype before weighting; the shared expert is a
  GLU MLP over x at width ``d_ff * n_shared_experts``.

The main path makes no host sync: every shape follows from x's, and the
capacity is computed on the host from those shapes.

Expert parallelism (training on a mesh whose ``model`` axis splits the
experts: the reference's ``("tp", "fsdp", None)`` specs). A rank's expert
leaves hold ``E_l = E / model`` experts, the block that starts at expert
``axis_rank(mi, "model") * E_l``; both versions see it from the leaves'
shape (``w_gate.shape[0] < E``). Routing stays whole on every rank (fp32
logits over all E, top-K, positions and capacity of the whole group), and
each returns the partial sum over its own experts (plus its part of the
shared expert, whose hidden units split as the dense MLP's): the
caller sums the ranks' partials (``blocks._apply_moe``). Where the rows of
the token batch split over other ranks (``row_axes``, the data axes of a
train step), the reference's groups are those of the global batch, and a
rank's rows hold ``G / n`` of them (``n`` the ranks its rows split over:
gcd(n * T, n * w) = n * gcd(T, w)).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.dist import NO_MESH, MeshInfo, axis_rank
from repro_torch.models.layers import _ACTS, glu_mlp
from repro_torch.models.params import ParamSpec, glu_specs, residual


def moe_specs(cfg: ModelConfig, damp: float) -> Dict[str, object]:
    """Router (d, E) float32 at std d**-0.5 (not damped); the experts'
    (E, d, d_ff) gate and up and (E, d_ff, d) down, whose fan-in is d_ff
    and which is damped as every ``w_down``; the shared expert's GLU."""
    m = cfg.moe
    d, E = cfg.d_model, m.n_experts
    out: Dict[str, object] = {
        "router": ParamSpec((d, E), "normal", d ** -0.5, dtype="float32",
                            pspec=("fsdp", None)),
        "w_gate": ParamSpec((E, d, m.d_ff), pspec=("tp", "fsdp", None)),
        "w_up": ParamSpec((E, d, m.d_ff), pspec=("tp", "fsdp", None)),
        "w_down": residual((E, m.d_ff, d), damp, ("tp", None, "fsdp"))}
    if m.n_shared_experts:
        out["shared"] = glu_specs(d, m.d_ff * m.n_shared_experts, damp)
    return out


def capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots an expert holds for ``n_tokens`` tokens (Python floats, in the
    reference's order of operations)."""
    return max(int(math.ceil(n_tokens * m.experts_per_token / m.n_experts
                             * m.capacity_factor)), 1)


def _n_groups(n_tokens: int, mi: MeshInfo) -> int:
    """Token groups: the reference's, which shard over the whole mesh (the
    gcd of the token count and the mesh's size; 1 without a mesh)."""
    want = 1
    for a in mi.all_axes:
        want *= mi.size(a)
    return max(math.gcd(n_tokens, max(want, 1)), 1)


def local_groups(n_tokens: int, mi: MeshInfo, row_axes=()) -> int:
    """The groups of a rank's ``n_tokens`` tokens, where the token batch's
    rows split over the ranks of ``row_axes``: the global batch's
    :func:`_n_groups` over the number of those ranks."""
    n = math.prod(mi.size(a) for a in row_axes)
    return _n_groups(n_tokens * n, mi) // n


def _expert_block(p: dict, cfg: ModelConfig, mi: MeshInfo) -> Tuple[int, int]:
    """(first expert, experts) of the block the expert leaves hold: all E,
    or under expert parallelism the rank's E / model from
    ``axis_rank(mi, "model") * E / model``."""
    E, E_l = cfg.moe.n_experts, p["w_gate"].shape[0]
    if E_l == E:
        return 0, E
    if E_l * mi.size("model") != E:
        raise ValueError(f"{E_l} experts a rank do not split {E} over a "
                         f"model axis of {mi.size('model')}")
    return axis_rank(mi, "model") * E_l, E_l


def route(p: dict, x2: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 (T, d) -> (experts (T, K) int64, gates (T, K) fp32): each token's
    top-K experts, highest probability first and ties to the lower index,
    and their probabilities renormalised to sum to one (before any drop)."""
    K = cfg.moe.experts_per_token
    logits = x2.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    # torch.topk does not promise an order among equal values; a stable
    # descending sort keeps the lower index first, as jax.lax.top_k does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return experts, gates


def positions(experts: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """(T, K) each choice's position in its expert's buffer of its token
    group (``groups`` consecutive runs of T / groups tokens), choice-major
    within the group, by a stable sort of the choices by (group, expert): a
    choice's rank among those of its group and expert, with no (T, K, E)
    one-hot."""
    T, K = experts.shape
    tg = T // groups
    gid = torch.arange(groups, device=experts.device)[:, None, None]
    flat = (experts.reshape(groups, tg, K).transpose(1, 2)
            + (gid << 32)).reshape(-1)                 # choice-major a group
    order = torch.argsort(flat, stable=True)
    ranked = flat[order]
    first = torch.searchsorted(ranked, ranked)         # where its run starts
    rank = torch.arange(flat.numel(), device=flat.device) - first
    pos = torch.empty_like(flat).scatter_(0, order, rank)
    return pos.view(groups, K, tg).transpose(1, 2).reshape(T, K)


def moe_ffn_ref(p: dict, x: torch.Tensor, cfg: ModelConfig,
                mi: MeshInfo = NO_MESH, return_keep: bool = False,
                row_axes=()):
    """The plain version: the reference's ``moe_ffn`` line for line, its
    (G, Tg, E, C) combine and dispatch tensors included. x (B, S, d) ->
    (B, S, d), and the (T, K) keep mask if ``return_keep``. On a block of
    the experts, ``combine`` and ``dispatch`` are sliced to its E."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = local_groups(T, mi, row_axes)
    Tg = T // G
    E = m.n_experts
    C = capacity(Tg, m)
    xt = x.reshape(G, Tg, d)
    experts, gates = route(p, x.reshape(T, d), cfg)
    K = experts.shape[1]
    experts, gates = experts.reshape(G, Tg, K), gates.reshape(G, Tg, K)
    onehot = F.one_hot(experts, E).to(torch.int32)              # (G,Tg,K,E)
    oh_flat = onehot.transpose(1, 2).reshape(G, K * Tg, E)      # choice-major
    pos_flat = torch.cumsum(oh_flat, dim=1) - 1
    pos = (pos_flat.reshape(G, K, Tg, E).transpose(1, 2) * onehot).sum(-1)
    keep = pos < C
    gates = gates * keep
    slot_oh = F.one_hot(torch.where(keep, pos, C), C + 1).to(
        x.dtype)[..., :C]                                       # (G,Tg,K,C)
    combine = torch.einsum("gtke,gtkc->gtec", onehot.to(x.dtype)
                           * gates[..., None].to(x.dtype), slot_oh)
    e0, E_l = _expert_block(p, cfg, mi)
    combine = combine[:, :, e0:e0 + E_l]
    dispatch = (combine > 0).to(x.dtype)
    de = torch.einsum("gtec,gtd->gecd", dispatch, xt)           # (G,E,C,d)
    h = _ACTS[cfg.act](torch.einsum("gecd,edf->gecf", de, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", de, p["w_up"])
    eo = torch.einsum("gecf,efd->gecd", h, p["w_down"])         # (G,E,C,d)
    out = torch.einsum("gtec,gecd->gtd", combine, eo).reshape(B, S, d)
    if "shared" in p:
        out = out + glu_mlp(p["shared"], x, cfg.act)
    keep = keep.reshape(T, K)
    return (out, keep) if return_keep else out


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            mi: MeshInfo = NO_MESH, return_keep: bool = False,
            row_axes=()):
    """The main path, the same function as :func:`moe_ffn_ref`: each kept
    (token, choice) pair of group g fills row ``(expert * G + g) * C +
    position`` of an (E*G*C + 1, d) buffer by a gather of x (empty rows
    read a zero row), the three expert products run as batched matmuls
    over (E, G*C, .), and each token sums its K gated rows of the output
    (a dropped pair reads the last, zero row at gate 0). On a block of
    E_l experts from e0 the buffer holds only their rows, the contiguous
    range from ``e0 * G * C``; every other pair goes to the trash row."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = local_groups(T, mi, row_axes)
    K = m.experts_per_token
    e0, E = _expert_block(p, cfg, mi)
    C = capacity(T // G, m)
    dev = x.device
    xt = x.reshape(T, d)
    experts, gates = route(p, xt, cfg)
    pos = positions(experts, G)
    keep = pos < C
    trash = E * G * C
    group = torch.arange(T, device=dev)[:, None] // (T // G)
    if E == m.n_experts:
        slot = torch.where(keep, (experts * G + group) * C + pos, trash)
    else:
        mine = keep & (experts >= e0) & (experts < e0 + E)
        slot = torch.where(mine, ((experts - e0) * G + group) * C + pos,
                           trash)
    # The token each buffer row holds (T: none). Kept slots are distinct;
    # only the trash row, never read, is written more than once.
    tokens = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    src = torch.full((trash + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot.reshape(-1), tokens)
    xz = torch.cat([xt, xt.new_zeros(1, d)])
    buf = xz[src[:trash]].view(E, G * C, d)
    h = _ACTS[cfg.act](torch.bmm(buf, p["w_gate"])) \
        * torch.bmm(buf, p["w_up"])
    eo = torch.bmm(h, p["w_down"]).view(trash, d)
    eo = torch.cat([eo, eo.new_zeros(1, d)])
    w = (gates * keep).to(x.dtype)
    out = torch.bmm(w[:, None, :], eo[slot]).view(B, S, d)
    if "shared" in p:
        out = out + glu_mlp(p["shared"], x, cfg.act)
    return (out, keep) if return_keep else out


def aux_load_balance_loss(p: dict, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E * sum over experts of
    (share of tokens whose top-1 is the expert) * (mean probability), in
    fp32; the top-1 takes the lower index on a tie, as ``jnp.argmax``."""
    E = cfg.moe.n_experts
    probs = torch.softmax((x.float() @ p["router"]).reshape(-1, E), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, E).float().mean(0)
    return E * torch.sum(frac * probs.mean(0))
