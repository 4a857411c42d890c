"""Heat-driven demote/promote policy for the two-lane store (the
counterpart of `repro.tier.policy`).

`tier_maintain` is one batched transition: it folds the traversal heat
counters into a per-node EWMA, ranks live nodes by that score, and moves
at most `max_demote` / `max_promote` nodes across the lane boundary.
Hysteresis keeps the boundary from thrashing: a hot node is demoted only
when its rank falls below the budget by the hysteresis margin, and a
cold node is promoted only when it climbs above the budget by the same
margin.

Ties rank as the reference's do: `jnp.argsort` and `lax.top_k` are
stable (the lower index first), so the port sorts with `stable=True`.
The EWMA rounds as the reference's compiled arithmetic does: XLA
contracts ``a * heat + (1 - a) * old`` into one FMA over the rounded
second product, which `hnsw._fma32` reproduces through f64.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hnsw import _fma32
from repro_torch.core.iostats import IOStats
from repro_torch.tier.quant import quantize_rows


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Knobs of one `tier_maintain` transition.

    hot_frac    — resident dense-lane budget as a fraction of live nodes.
    ewma        — weight of the *new* heat observation in the EWMA.
    hysteresis  — dead band around the budget rank, as a fraction of
                  `k_hot`; larger = fewer lane flips under noisy heat.
    max_demote  — per-call cap on hot->cold moves (batched quantize).
    max_promote — per-call cap on cold->hot moves (each is one modeled
                  full-row fetch from the cold store, counted in n_vec).
    """

    hot_frac: float = 0.25
    ewma: float = 0.5
    hysteresis: float = 0.1
    max_demote: int = 256
    max_promote: int = 64


def _top_ids(pri: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """The ids of the n largest priorities, ties to the lower id
    (`lax.top_k`); entries whose priority is -inf become `cap`."""
    order = torch.sort(-pri, stable=True).indices[:n]
    return torch.where(torch.isfinite(pri[order]), order, cap)


def tier_maintain(cfg, state, policy: TierPolicy):
    """One batched demote/promote pass.  Returns (state', io, moved).

    `moved` is a dict of scalar int32 tensors {"demoted", "promoted"}.
    The traversal heat counters in `state.heat` are read, not reset.
    The cold lane (`qvecs`, `qscale`) is written in place; `hot` and
    `tier_heat` are new tensors.
    """
    cap = cfg.cap
    dev = state.levels.device
    f32 = torch.float32
    live = (state.levels >= 0) & ~state.tombstone

    node_heat = state.heat.sum(1, dtype=torch.int32).to(f32)
    a = torch.tensor(policy.ewma, dtype=f32, device=dev)
    tier_heat = _fma32(a, node_heat, (1.0 - a) * state.tier_heat)

    # rank live nodes by heat (0 = hottest); dead slots sort to the end
    # and can never cross the demote/promote thresholds
    score = torch.where(live, tier_heat, -torch.inf)
    order = torch.sort(-score, stable=True).indices
    rank = torch.empty((cap,), dtype=f32, device=dev)
    rank[order] = torch.arange(cap, dtype=f32, device=dev)

    n_live = state.n_live.clamp_min(1).to(f32)
    k_hot = torch.ceil(torch.tensor(policy.hot_frac, dtype=f32,
                                    device=dev) * n_live)
    demote_edge = k_hot * (1.0 + policy.hysteresis)
    promote_edge = torch.clamp_min(k_hot * (1.0 - policy.hysteresis), 1.0)

    demote_mask = state.hot & live & (rank >= demote_edge)
    promote_mask = ~state.hot & live & (rank < promote_edge)

    # coldest demote candidates / hottest promote candidates first,
    # capped at the policy's batch sizes
    d_ids = _top_ids(torch.where(demote_mask, -tier_heat, -torch.inf),
                     min(int(policy.max_demote), cap), cap)
    p_ids = _top_ids(torch.where(promote_mask, tier_heat, -torch.inf),
                     min(int(policy.max_promote), cap), cap)

    # demote: quantize the dense rows into the cold lane, clear hot;
    # promote: flip the lane bit (the dense row is re-fetched from the
    # modeled disk, one n_vec read each).  The ids of a pass are
    # distinct, so the scatters are deterministic.
    d_sel = d_ids[d_ids < cap].long()
    p_sel = p_ids[p_ids < cap].long()
    q, scales = quantize_rows(state.vectors[d_sel])
    state.qvecs[d_sel] = q
    state.qscale[d_sel] = scales
    hot = state.hot.clone()
    hot[d_sel] = False
    hot[p_sel] = True

    n_demoted = (d_ids < cap).sum().to(torch.int32)
    n_promoted = (p_ids < cap).sum().to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    io = IOStats(zero, n_promoted, zero, zero)
    state = state._replace(hot=hot, tier_heat=tier_heat)
    return state, io, {"demoted": n_demoted, "promoted": n_promoted}
