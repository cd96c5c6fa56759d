"""Input-shape variants, training defaults and the sharded step builders
of the LM zoo.

Counterpart of ``repro/launch/steps.py``: the long-context sliding-window
variant and the cache capacity it implies, the gradient-accumulation
factor of a training shape, each config's optimizer, and
:func:`build_step`, which assembles a :class:`StepBundle` (the step
function, the DTensor placements of its inputs and outputs, and
meta-device stand-ins for its inputs) for train / prefill / decode of
any (arch × shape × mesh).  ``bundle.run(*inputs)`` runs the step on
real tensors laid out on the mesh (JAX's ``bundle.jitted()``);
``bundle.trace()`` runs it on meta-device shards under the census
(:mod:`repro_torch.launch.census`), the dry-run's counterpart of
``lower()``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch.census import Census
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import lm
from repro_torch.optim import Optimizer, adafactor, adamw
from repro_torch.tree import tree_leaves, tree_unflatten

# long-context attention variant: ring-buffer sliding window
LONG_CONTEXT_WINDOW = 8192


def default_microbatches(cfg: ModelConfig, shape: InputShape) -> int:
    """Gradient-accumulation factor of a training shape, by the model's
    width class and family (the JAX package's table, sized for the
    saved activations of its pod runs); 1 for any other shape."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192:
        return 16
    if cfg.family in ("ssm", "hybrid"):
        return 8           # SSD intra-chunk buffers dominate saved memory
    if cfg.d_model >= 6144 or cfg.family == "vlm":
        return 8
    if cfg.num_experts:
        return 8
    return 4


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    """Adafactor(1e-3) where the config asks for it (the 340B-class
    configs), else AdamW(3e-4)."""
    return adafactor(1e-3) if cfg.optimizer == "adafactor" else adamw(3e-4)


def shape_variant(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long-context SWA variant for attention architectures."""
    if shape.name == "long_500k" and cfg.family != "ssm" \
            and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    cap = shape.seq_len
    if cfg.sliding_window is not None:
        cap = min(cap, cfg.sliding_window)
    return cap


# -- sharded step builders ------------------------------------------------------

def is_placements(x) -> bool:
    """A leaf of a placement tree: one placement per mesh dim."""
    return isinstance(x, tuple) and bool(x) \
        and all(isinstance(p, Placement) for p in x)


def _local_shape(shape, mesh, placements) -> tuple[int, ...]:
    """This rank's shard of a tensor of ``shape`` (``torch.chunk``'s split,
    mesh dims in order, as DTensor lays shards out)."""
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n, c = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-local[p.dim] // n)
            local[p.dim] = max(0, min(chunk, local[p.dim] - c * chunk))
    return tuple(local)


def lay_out(mesh, tree, placement_tree) -> Any:
    """A tree of tensors as DTensors on ``mesh``: a plain leaf (the same
    values on every rank) cut to this rank's shard without communication;
    a DTensor leaf redistributed where its placements differ."""
    rep = (Replicate(),) * mesh.ndim

    def one(t, pl):
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl \
                else t.redistribute(mesh, pl)
        return DTensor.from_local(t, mesh, rep, run_check=False) \
            .redistribute(mesh, pl)

    return tree_unflatten(tree, [
        one(t, pl) for t, pl in zip(tree_leaves(tree), tree_leaves(
            placement_tree, is_leaf=is_placements))])


def meta_shards(mesh, tree, placement_tree) -> Any:
    """Meta-device stand-ins as DTensors over meta-device local shards:
    no memory, and the collectives they issue move nothing."""
    def one(m, pl):
        local = torch.empty(_local_shape(m.shape, mesh, pl), dtype=m.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=m.shape, stride=m.stride())
    return tree_unflatten(tree, [
        one(m, pl) for m, pl in zip(tree_leaves(tree), tree_leaves(
            placement_tree, is_leaf=is_placements))])


def local_bytes(tree) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class StepBundle:
    fn: Any
    in_placements: tuple            # a placement tree per positional input
    out_placements: Any             # per output; None: as fn leaves it
    abstract_inputs: tuple          # meta-device tensors, positional
    cfg: ModelConfig
    rules: sh.ShardingRules
    donate: tuple = ()              # JAX's donate_argnums, as metadata

    @property
    def mesh(self):
        return self.rules.mesh

    def run(self, *inputs):
        """``fn`` on real inputs (plain tensors holding the same values on
        every rank, or DTensors), laid out on the mesh first; the outputs
        laid out as ``out_placements`` says."""
        args = [lay_out(self.mesh, x, pl)
                for x, pl in zip(inputs, self.in_placements)]
        return self._place_outputs(self.fn(*args))

    def _place_outputs(self, out):
        if self.out_placements is None:
            return out
        return tuple(o if pl is None else lay_out(self.mesh, o, pl)
                     for o, pl in zip(out, self.out_placements))

    def trace(self) -> dict:
        """``fn`` on meta-device shards of ``abstract_inputs`` under the
        census: one rank's FLOPs, HBM and collective bytes, and its memory
        (the local bytes of the arguments and outputs, and the step's
        peak of live bytes above the arguments), with the seconds the
        trace took."""
        t0 = time.perf_counter()
        args = [meta_shards(self.mesh, x, pl)
                for x, pl in zip(self.abstract_inputs, self.in_placements)]
        with Census() as c:
            out = self._place_outputs(self.fn(*args))
        memory = {"argument_size_in_bytes": local_bytes(args),
                  "output_size_in_bytes": local_bytes(out),
                  "temp_size_in_bytes": c.peak}
        rec = c.record()
        del rec["peak_bytes"]            # as temp_size_in_bytes
        rec["memory"] = memory
        rec["trace_s"] = time.perf_counter() - t0
        return rec


def _batch_struct(cfg: ModelConfig, shape: InputShape, *, seq: int,
                  with_labels: bool) -> dict:
    """Meta-device stand-ins of a forward / training batch."""
    b = shape.global_batch

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out = {"tokens": meta((b, seq), torch.int32)}
    if with_labels:
        out["labels"] = meta((b, seq), torch.int32)
    if cfg.family == "vlm":
        out["vision"] = meta((b, cfg.vision_tokens, cfg.vision_dim),
                             cfg.dtype)
    if cfg.family == "audio":
        out["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return out


def _cache_struct(cfg: ModelConfig, shape: InputShape) -> dict:
    cap = cache_capacity(cfg, shape)
    return lm.init_cache(cfg, shape.global_batch, cap,
                         prefill_len=min(shape.seq_len, cap) - 1,
                         device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-device stand-ins for every model input of this shape: no
    memory, shardable."""
    cfg = shape_variant(cfg, shape)
    if shape.kind in ("train", "prefill"):
        return _batch_struct(cfg, shape, seq=shape.seq_len,
                             with_labels=shape.kind == "train")
    return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                  device="meta"),
            "cache": _cache_struct(cfg, shape)}


def build_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               microbatches: int | None = None,
               seq_parallel: bool | None = None,
               fsdp_threshold: float = 5e9) -> StepBundle:
    """The step of ``shape``'s kind for ``cfg`` on ``mesh`` (a
    ``DeviceMesh``), with JAX's choices: grouped MoE dispatch aligned with
    the data axis when the tokens divide it, the rules' FSDP and
    sequence-parallel switches, the default microbatches, bf16 gradient
    accumulation for Adafactor configs, per-layer block layouts without
    the stacked axis, and the decode cache's and tokens' layouts."""
    cfg = shape_variant(cfg, shape)
    if cfg.num_experts and cfg.moe_groups == 0:
        data = axis_sizes(mesh).get("data", 1)
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        if data > 1 and tokens % data == 0:
            cfg = dataclasses.replace(cfg, moe_groups=data)
    rules = sh.make_rules(mesh, cfg, seq_parallel=seq_parallel,
                          fsdp_threshold=fsdp_threshold)
    constrain = functools.partial(sh.logical_constraint, rules,
                                  kind="residual")

    pshapes = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    pspecs = sh.param_specs(rules, pshapes)
    ppl = sh.to_placements(mesh, pspecs)
    bpl = sh.to_placements(mesh, sh.batch_specs(rules, cfg, shape))

    if shape.kind == "train":
        opt = make_optimizer(cfg)
        oshapes = opt.init(tree_leaves(pshapes))
        opl = sh.to_placements(mesh, sh.opt_specs(rules, oshapes, pspecs))
        mb = microbatches if microbatches is not None \
            else default_microbatches(cfg, shape)
        # 340B-class configs accumulate grads in bf16 (Adafactor's update
        # clipping tolerates it); everything else in fp32
        accum = torch.bfloat16 if cfg.optimizer == "adafactor" \
            else torch.float32
        grad_pl = tree_leaves(ppl, is_leaf=is_placements)

        def constrain_grads(grads):
            return [g.redistribute(mesh, pl) if isinstance(g, DTensor) else g
                    for g, pl in zip(grads, grad_pl)]

        layer_pl = None
        if isinstance(pspecs.get("blocks"), dict):
            layer_pl = sh.to_placements(mesh, tree_unflatten(
                pspecs["blocks"], [sh.P(*s[1:]) for s in
                                   sh.spec_leaves(pspecs["blocks"])],
                is_leaf=sh.is_spec))

        def constrain_block_params(lp):
            return lp if layer_pl is None else lay_out(mesh, lp, layer_pl)

        step = lm.make_train_step(
            cfg, opt, microbatches=mb, constrain=constrain,
            constrain_logits=functools.partial(sh.logical_constraint, rules,
                                               kind="logits"),
            accum_dtype=accum, constrain_grads=constrain_grads,
            constrain_block_params=constrain_block_params)
        batch = _batch_struct(cfg, shape, seq=shape.seq_len,
                              with_labels=True)
        return StepBundle(fn=step, in_placements=(ppl, opl, bpl),
                          out_placements=(ppl, opl, None),
                          abstract_inputs=(pshapes, oshapes, batch),
                          cfg=cfg, rules=rules, donate=(0, 1))

    if shape.kind == "prefill":
        def prefill(params, batch):
            logits, _ = lm.forward(params, cfg, batch, constrain=constrain)
            return sh.logical_constraint(rules, logits, "logits")

        batch = _batch_struct(cfg, shape, seq=shape.seq_len,
                              with_labels=False)
        return StepBundle(fn=prefill, in_placements=(ppl, bpl),
                          out_placements=None,
                          abstract_inputs=(pshapes, batch), cfg=cfg,
                          rules=rules)

    cshapes = _cache_struct(cfg, shape)
    cpl = sh.to_placements(mesh, sh.cache_specs(rules, cfg, cshapes,
                                                shape.global_batch))
    dp = rules.dp_axes
    tok_pl = sh.placements(sh.P(
        dp if shape.global_batch % rules.axis_size(dp) == 0 else None,
        None), mesh)

    def serve_step(params, tokens, cache):
        return lm.decode_step(params, cfg, tokens, cache)

    toks = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                       device="meta")
    return StepBundle(fn=serve_step, in_placements=(ppl, tok_pl, cpl),
                      out_placements=(None, cpl),
                      abstract_inputs=(pshapes, toks, cshapes), cfg=cfg,
                      rules=rules, donate=(2,))
