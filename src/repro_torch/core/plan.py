"""ShardingPlan: solved tilings -> partition specs (the port's copy of
``repro.core.plan``).

The solver works on logical tensors with *named* dims; physical arrays in
the model have per-axis dim names too (models/sharding.py rules map param
paths -> (role, phys_dims)).  A mesh axis that chose Part(d) for a role is
placed on the first physical axis named ``d``; several mesh axes on the
same name stack into a tuple.

A spec is a plain tuple with the entries of repro's ``PartitionSpec``:
per physical dim ``None`` (not cut), a mesh axis name, or a tuple of axis
names (stacked, the first one major), trailing ``None``s trimmed.
``models/sharding.py`` turns it into DTensor placements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .solver import TilingSolution
from .tiling import Part, REPLICATE

# roles carried by the decode-time cache/state pytree (models/sharding.py
# CACHE_RULES maps the cache leaves onto them); the serving engine shards
# the pool cache through these
CACHE_ROLES = ("kv_cache", "ssm_state", "block_table")

# one entry per physical dim: None, an axis name, or stacked axis names
Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]


@dataclasses.dataclass
class ShardingPlan:
    mesh_axis_names: Tuple[str, ...]
    # role -> {mesh_axis_name -> partitioned dim name or None}
    role_cuts: Dict[str, Dict[str, Optional[str]]]

    @classmethod
    def from_graph_solution(cls, sol: TilingSolution, g) -> "ShardingPlan":
        """Extract role->cut mapping from a solved semantic graph (tensors
        carry their role; the first tensor seen per role wins — builders
        keep per-role tilings consistent across layer instances)."""
        roles: Dict[str, str] = {}
        for name, ts in g.tensors.items():
            if ts.role and ts.role not in roles.values():
                roles.setdefault(name, ts.role)
        return cls.from_solution(sol, roles)

    @classmethod
    def from_solution(cls, sol: TilingSolution,
                      tensor_roles: Dict[str, str]) -> "ShardingPlan":
        """tensor_roles: graph tensor name -> role key."""
        role_cuts: Dict[str, Dict[str, Optional[str]]] = {}
        for tname, role in tensor_roles.items():
            cuts: Dict[str, Optional[str]] = {}
            for ax, assign in zip(sol.axes, sol.per_axis):
                t = assign.get(tname, REPLICATE)
                cuts[ax.name] = t.dim if isinstance(t, Part) else None
            role_cuts[role] = cuts
        return cls(tuple(ax.name for ax in sol.axes), role_cuts)

    def has_role(self, role: str) -> bool:
        return role in self.role_cuts

    def pspec(self, role: str, phys_dims: Sequence[str],
              default: Optional[Spec] = None) -> Spec:
        """Partition spec for a physical array whose axes are named
        ``phys_dims``.  Unknown roles return ``default``, or fully
        replicated (``()``) when no default is given.  Callers that need
        to *distinguish* an unknown role (e.g. to skip a sharding
        constraint entirely) should check :meth:`has_role` first."""
        cuts = self.role_cuts.get(role)
        if cuts is None:
            return () if default is None else default
        entries: List[List[str]] = [[] for _ in phys_dims]
        for ax in self.mesh_axis_names:
            d = cuts.get(ax)
            if d is None:
                continue
            for i, pd in enumerate(phys_dims):
                if pd == d:
                    entries[i].append(ax)
                    break
        spec = []
        for e in entries:
            if not e:
                spec.append(None)
            elif len(e) == 1:
                spec.append(e[0])
            else:
                spec.append(tuple(e))
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def for_pool(self, n_slots: int,
                 axis_sizes: Dict[str, int]) -> "ShardingPlan":
        """Serving variant of the plan: the pool's slot count replaces
        the solved shape's batch size, and a slot pool is placed in even
        shards only — so drop ``batch`` cuts (on cache,
        activation and logits roles alike) on mesh axes that no longer
        divide ``n_slots``.  Axes are considered in mesh order so stacked
        batch cuts keep the largest dividing prefix; every non-batch cut
        survives unchanged."""
        rc: Dict[str, Dict[str, Optional[str]]] = {}
        for role, cuts in self.role_cuts.items():
            c = dict(cuts)
            prod = 1
            for ax in self.mesh_axis_names:
                if c.get(ax) != "batch":
                    continue
                size = axis_sizes.get(ax, 1)
                if n_slots % (prod * size):
                    c[ax] = None
                else:
                    prod *= size
            rc[role] = c
        return ShardingPlan(self.mesh_axis_names, rc)

    def with_override(self, role: str,
                      cuts: Dict[str, Optional[str]]) -> "ShardingPlan":
        rc = dict(self.role_cuts)
        rc[role] = cuts
        return ShardingPlan(self.mesh_axis_names, rc)

    def describe(self) -> str:
        lines = []
        for role in sorted(self.role_cuts):
            cuts = self.role_cuts[role]
            s = ", ".join(f"{a}->{d}" for a, d in cuts.items() if d)
            lines.append(f"  {role:24s} [{s or 'replicated'}]")
        return "\n".join(lines)


def manual_megatron_plan(mesh_axis_names: Sequence[str],
                         data_axes: Sequence[str],
                         model_axis: str) -> ShardingPlan:
    """Hand-written Megatron-style baseline plan (for comparison against
    the solver's output): batch on data axes, attention heads / ffn hidden
    / vocab / experts on the model axis."""
    def cuts(**kw):
        c = {a: None for a in mesh_axis_names}
        c.update(kw)
        return c

    da = {a: "batch" for a in data_axes}
    role_cuts = {
        "x":        cuts(**da),
        "logits":   cuts(**da, **{model_axis: "vocab"}),
        "embed":    cuts(**{model_axis: "vocab"}),
        "lm_head":  cuts(**{model_axis: "vocab"}),
        "wq":       cuts(**{model_axis: "heads"}),
        "wk":       cuts(**{model_axis: "heads"}),
        "wv":       cuts(**{model_axis: "heads"}),
        "wo":       cuts(**{model_axis: "heads"}),
        "w_gate":   cuts(**{model_axis: "d_ff"}),
        "w_up":     cuts(**{model_axis: "d_ff"}),
        "w_down":   cuts(**{model_axis: "d_ff"}),
        "moe_gate": cuts(),
        "moe_up":   cuts(**{model_axis: "expert"}),
        "moe_down": cuts(**{model_axis: "expert"}),
        "ssm_in":   cuts(**{model_axis: "inner"}),
        "ssm_out":  cuts(**{model_axis: "inner"}),
        "kv_cache": cuts(**da, **{model_axis: "heads"}),
        "ssm_state": cuts(**da, **{model_axis: "inner"}),
        # paged serving: the block table rides the same batch cut as the
        # cache rows it indexes (the pool itself has no batch axis)
        "block_table": cuts(**da),
        "norm":     cuts(),
    }
    return ShardingPlan(tuple(mesh_axis_names), role_cuts)
