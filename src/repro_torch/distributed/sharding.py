"""Named sharding rules for the architecture zoo.

Counterpart of ``repro/distributed/sharding.py``, rule for rule:

* ``model`` mesh axis: tensor parallelism — attention heads, FFN hidden,
  vocab, experts.
* ``data`` mesh axis: batch parallelism; for large architectures (param
  count over ``fsdp_threshold``) it also shards the weights' non-model
  dimension (ZeRO-3 / FSDP).
* ``pod`` mesh axis (multi-pod): pure data parallelism across pods; under
  the federated mapping each pod is a silo and the cross-pod mean is the
  aggregation (:mod:`repro_torch.launch.fedrun`).

A dimension is sharded only when the axis size divides it; otherwise it
stays replicated (kv_heads=5 on a 16-way model axis shards the cache
along its sequence instead).

A spec is a :class:`P`: a tuple with one entry per tensor dim, each a mesh
axis name, a tuple of names (the dim split over several axes, major
first) or None.  Spec trees have the structure of the tensor trees they
describe, walked in JAX's leaf order (:mod:`repro_torch.tree`), so a test
holds them to JAX's ``PartitionSpec`` trees leaf for leaf.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), None)``.
    A one-name tuple entry is that name, as JAX's ``PartitionSpec`` keeps
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def spec_leaves(tree) -> list[P]:
    """The specs of a spec tree in JAX's leaf order."""
    return tree_leaves(tree, is_leaf=is_spec)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardingRules:
    mesh: Any                       # an AbstractMesh or a DeviceMesh
    fsdp: bool                      # shard weight non-model dims over data
    seq_parallel: bool = False      # residual stream seq dim over model

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(axis_sizes(self.mesh))

    @property
    def dp_axes(self) -> tuple:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    def axis_size(self, name) -> int:
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return axis_sizes(self.mesh).get(name, 1)

    def div(self, dim: int, axis) -> Optional[Any]:
        """axis if dim divides evenly, else None (replicate)."""
        return axis if dim % self.axis_size(axis) == 0 else None


def make_rules(mesh, cfg: ModelConfig, *, fsdp_threshold: float = 5e9,
               seq_parallel: Optional[bool] = None) -> ShardingRules:
    """FSDP above ``fsdp_threshold`` parameters; sequence-parallel
    residuals by default only for the 340B class (d_model >= 16384),
    where the saved activations cannot fit otherwise."""
    big = cfg.param_count() > fsdp_threshold
    sp = seq_parallel if seq_parallel is not None \
        else cfg.d_model >= 16384
    return ShardingRules(mesh=mesh, fsdp=big, seq_parallel=sp)


# -- parameter specs -----------------------------------------------------------

def _leaf_spec(rules: ShardingRules, path: tuple[str, ...],
               shape: tuple[int, ...]) -> P:
    """The spec of one parameter leaf, by its tree path.  Leading stacked
    layer dims are never sharded; the rules name the trailing dims of
    each kind of tensor."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    fsdp = "data" if rules.fsdp else None

    def spec(*trailing):
        lead = (None,) * (len(shape) - len(trailing))
        fixed = tuple(rules.div(shape[len(lead) + i], ax)
                      if ax is not None else None
                      for i, ax in enumerate(trailing))
        return P(*(lead + fixed))

    if name == "embed":
        return spec("model", fsdp)
    if name == "lm_head":
        return spec(fsdp, "model")
    if name == "vis_proj":
        return spec(None, fsdp)
    if name in ("wq", "wk", "wv"):             # (D, H, dh)
        return spec(fsdp, "model", None)
    if name == "wo":                           # (H, dh, D)
        return spec("model", None, fsdp)
    if name in ("w_uk", "w_uv"):               # MLA up-projections (r, H, d)
        return spec(fsdp, "model", None)
    if name == "w_dkv":
        return spec(None, fsdp)
    if name == "w_kr":
        return spec(None, None)
    # MoE experts, expert-parallel over the model axis: the expert weights
    # live under "moe" (rank does not tell them from stacked MLP weights)
    if parent == "moe" and name in ("w_in", "w_gate", "w_out"):
        return spec("model", None, fsdp)       # (E, D, F) / (E, F, D)
    if name in ("w_in", "w_gate"):             # dense MLP
        return spec(fsdp, "model")
    if name == "w_out":
        return spec("model", fsdp)
    if name == "b_in":
        return spec("model")
    if name == "router":
        return spec(None, None)
    if name == "in_zx":                        # SSM (D, 2·d_in), z|x aligned
        return spec(fsdp, "model")
    if name == "conv_x":                       # (W, d_in) depthwise
        return spec(None, "model")
    if name in ("conv_x_b", "norm_w"):         # (d_in,)
        return spec("model")
    if name in ("A_log", "dt_bias") or (parent == "ssm" and name == "D"):
        return spec("model")                   # (H,): replicated if H ∤ 16
    if name == "out_proj":                     # (d_in, D)
        return spec("model", fsdp)
    # in_BC, in_dt, conv_BC, norms, biases, gates, scalars
    return P(*((None,) * len(shape)))


def param_specs(rules: ShardingRules, params_shapes) -> Any:
    """A spec tree matching a params (shape) tree."""
    return tree_unflatten(params_shapes, [
        _leaf_spec(rules, tuple(path.split("/")), tuple(leaf.shape))
        for path, leaf in zip(tree_paths(params_shapes),
                              tree_leaves(params_shapes))])


def opt_specs(rules: ShardingRules, opt_state_shapes, pspecs) -> Any:
    """Optimizer-state specs.  Adam's moments mirror the params;
    Adafactor's factored statistics keep the leading entries of the
    param's spec, one per dim they have (JAX's truncation); scalar
    fields replicate.  The port's states hold their moments as lists in
    the params' leaf order, so they pair with :func:`spec_leaves`."""
    params_flat = spec_leaves(pspecs)

    def assign(state_tree):
        flat = tree_leaves(state_tree)
        if len(flat) == len(params_flat):
            out = [ps if len(ps) == leaf.dim() else P(*ps[: leaf.dim()])
                   for leaf, ps in zip(flat, params_flat)]
        else:
            out = [P(*((None,) * leaf.dim())) for leaf in flat]
        return tree_unflatten(state_tree, out)

    fields = getattr(opt_state_shapes, "_fields", None)
    if fields:
        out = {}
        for fname in fields:
            sub = getattr(opt_state_shapes, fname)
            leaves = tree_leaves(sub)
            if not leaves or all(leaf.dim() == 0 for leaf in leaves):
                out[fname] = tree_unflatten(sub, [P() for _ in leaves])
            else:
                out[fname] = assign(sub)
        return type(opt_state_shapes)(**out)
    return assign(opt_state_shapes)


# -- activation / input specs -----------------------------------------------

def batch_specs(rules: ShardingRules, cfg: ModelConfig,
                shape: InputShape) -> dict:
    dp = rules.dp_axes
    bspec = dp if shape.global_batch % rules.axis_size(dp) == 0 else None
    out = {"tokens": P(bspec, None)}
    if shape.kind == "train":
        out["labels"] = P(bspec, None)
    if cfg.family == "vlm":
        out["vision"] = P(bspec, None, None)
    if cfg.family == "audio":
        out["frames"] = P(bspec, None, None)
    return out


#: trailing rank of each cache leaf kind (the leading dims are stacked
#: layer axes, two of them for the VLM's nested super-block stacks)
_CACHE_TRAILING_RANK = {"k": 4, "v": 4, "cross_k": 4, "cross_v": 4,
                        "c_kv": 3, "k_rope": 3, "conv_x": 3, "conv_BC": 3,
                        "state": 4, "pos": 2, "valid": 2, "index": 1,
                        "length": 1}


def cache_specs(rules: ShardingRules, cfg: ModelConfig, cache_shapes,
                global_batch: int) -> Any:
    """Decode-cache specs: batch on the data axes when divisible; kv heads
    on model when divisible, else the cache's sequence dim on model."""
    dp = rules.dp_axes
    bs = dp if global_batch % rules.axis_size(dp) == 0 else None
    kv_on_model = cfg.num_kv_heads % rules.axis_size("model") == 0

    specs = []
    for path, leaf in zip(tree_paths(cache_shapes),
                          tree_leaves(cache_shapes)):
        name = next((k for k in reversed(path.split("/"))
                     if not k.isdigit()), "?")
        nd = leaf.dim()
        tr = _CACHE_TRAILING_RANK.get(name, nd)
        lead = (None,) * (nd - tr)
        shp = tuple(leaf.shape[nd - tr:])
        if name in ("k", "v"):                    # (B, T, Hkv, dh)
            s = (bs, None, "model", None) if kv_on_model \
                else (bs, rules.div(shp[1], "model"), None, None)
        elif name in ("cross_k", "cross_v"):
            s = (bs, None, "model" if kv_on_model else None, None)
        elif name in ("c_kv", "k_rope"):          # MLA latent (B, T, r)
            s = (bs, rules.div(shp[1], "model"), None)
        elif name == "conv_x":                    # (B, W-1, d_in)
            s = (bs, None, rules.div(shp[2], "model"))
        elif name == "conv_BC":                   # (B, W-1, 2N)
            s = (bs, None, None)
        elif name == "state":                     # (B, H, P, N)
            s = (bs, rules.div(shp[1], "model"), None, None)
        elif tr >= 1:                             # pos/valid/index/length
            s = (bs,) + (None,) * (tr - 1)
        else:
            s = ()
        specs.append(P(*(lead + s)))
    return tree_unflatten(cache_shapes, specs)


# -- DTensor placements ----------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """A spec's DTensor placements on ``mesh`` (a ``DeviceMesh`` or an
    :class:`~repro_torch.launch.mesh.AbstractMesh`): mesh dim i gets
    ``Shard(d)`` when tensor dim d's entry names its axis, else
    ``Replicate()``.  ``("pod", "data")`` on dim 0 is ``Shard(0)`` on
    both mesh dims, pod's chunk major, as JAX lays it out.  A mesh dim of
    size 1 replicates: the layout is the same, and DTensor would refuse
    views that drop a dim "sharded" over it."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax not in names:
                raise ValueError(f"{spec} names {ax!r}, the mesh has {names}")
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(d)
    return tuple(out)


def to_placements(mesh, spec_tree) -> Any:
    """A spec tree as a tree of placement tuples (JAX's ``_named``)."""
    return tree_unflatten(spec_tree, [placements(s, mesh)
                                      for s in spec_leaves(spec_tree)],
                          is_leaf=is_spec)


def logical_constraint(rules: ShardingRules, x, kind: str):
    """JAX's ``with_sharding_constraint`` for activations: a DTensor is
    redistributed to the kind's layout ("residual": batch over the data
    axes, the sequence over model when sequence-parallel; "logits": the
    vocab over model); a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dp = rules.dp_axes
    if kind == "residual":
        spec = P(dp, "model" if rules.seq_parallel else None, None)
    elif kind == "logits":
        spec = P(dp, None, "model")
    else:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
