"""The port's pod tooling on the CPU against the JAX package.

* (a)–(e) the sharding rules: every spec of the port's ``param_specs``,
  ``opt_specs``, ``batch_specs`` and ``cache_specs`` equal to JAX's
  ``PartitionSpec`` leaf for leaf (abstract meshes on both sides), the
  rules' FSDP and sequence-parallel switches equal, and nemotron-340B's
  parameter bytes per device on (16, 16) equal to the JAX test's
  arithmetic;
* (f) the census: exact FLOPs of a Python loop and of one rank's share
  of a column-parallel product, exact all-reduce bytes, on a ``fake``
  world of 256 ranks in this process;
* (g) the census of ``build_step``'s train step (2 microbatches, remat),
  prefill and decode on a 1×1 mesh against ``repro.launch.hlo_census``
  of JAX's jitted step on one CPU device: FLOPs within 5 % (measured:
  smollm and deepseek equal, mamba2 0.995–1.016, its SSD einsums
  contracted in another order);
* (h) a 4-rank gloo world, (data=2, model=2): the train step (AdamW, 2
  microbatches), prefill and 4 decode steps of reduced smollm and
  deepseek against the single-device port on the same inputs;
* (i) ``build_fed_round`` on plain tensors against JAX's ``fed_round``,
  and on a 2-rank (pod=2) gloo world against itself on plain tensors;
* (j) ``dryrun.run_one`` in a process of its own;
* ``input_specs`` against JAX's, and a decode step of each family (h)
  leaves out traced on a fake (data=2, model=2) world.

Tolerances are stated beside each check."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as JP

import _torch_dist_workers as workers
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import InputShape as JInputShape
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.fedrun import build_fed_round as j_build_fed_round
from repro.launch.hlo_census import census as j_census
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh
from repro.models import lm as jlm
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro_torch.configs import SHAPES, get_config, get_reduced, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.core.fedopt import replicate
from repro_torch.data import synthetic_batches
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.census import census
from repro_torch.launch.fedrun import build_fed_round
from repro_torch.launch.mesh import make_abstract_mesh, make_host_mesh
from repro_torch.models import lm
from repro_torch.optim import adafactor, adamw, from_jax_opt_state
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
LOSS_TOL = 1e-5           # tests/test_torch_lm_train.py's tolerances
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-5          # of the largest |logit|
FED_TOL = 1e-6            # of each anchor leaf's largest |value|


def _j_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _specs(tree):
    return [tuple(s) for s in sh.spec_leaves(tree)]


def _rules(cfg, jcfg, kind):
    shape, axes = MESHES[kind]
    return (sh.make_rules(make_abstract_mesh(shape, axes), cfg),
            jsh.make_rules(j_abstract_mesh(shape, axes), jcfg))


def _j_param_shapes(jcfg):
    return jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))


def _param_shapes(cfg):
    return lm.init_params(cfg, generator=torch.Generator(), device="meta")


# -- (a)–(e) the rules ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch, kind):
    """(a) and (b): every parameter spec, and the FSDP and
    sequence-parallel switches, equal to JAX's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    rules, jrules = _rules(cfg, jcfg, kind)
    assert (rules.fsdp, rules.seq_parallel) == (jrules.fsdp,
                                                jrules.seq_parallel)
    assert rules.dp_axes == jrules.dp_axes
    pshapes = _param_shapes(cfg)
    got = _specs(sh.param_specs(rules, pshapes))
    want = _j_specs(jsh.param_specs(jrules, _j_param_shapes(jcfg)))
    assert len(got) == len(tree_leaves(pshapes))
    assert got == want


@pytest.mark.parametrize("seq_parallel", [None, False, True])
def test_make_rules_switches_match_jax(seq_parallel):
    """(b): the switches for every arch at three FSDP thresholds and
    each sequence-parallel override."""
    for arch in list_archs():
        for thr in (1e8, 5e9, 1e12):
            shape, axes = MESHES["single"]
            r = sh.make_rules(make_abstract_mesh(shape, axes),
                              get_config(arch), fsdp_threshold=thr,
                              seq_parallel=seq_parallel)
            j = jsh.make_rules(j_abstract_mesh(shape, axes),
                               j_get_config(arch), fsdp_threshold=thr,
                               seq_parallel=seq_parallel)
            assert (r.fsdp, r.seq_parallel) == (j.fsdp, j.seq_parallel)


def test_nemotron_param_bytes_per_device():
    """(c): nemotron-340B's parameter bytes per device on (16, 16), by
    ``tests/test_distributed.py``'s arithmetic on each side: equal byte
    for byte, and under 4 GiB."""
    cfg, jcfg = get_config("nemotron-4-340b"), j_get_config(
        "nemotron-4-340b")
    rules, jrules = _rules(cfg, jcfg, "single")
    sizes = MESHES["single"][0]
    axis = dict(zip(MESHES["single"][1], sizes))

    def per_device(leaves, specs):
        total = 0
        for shape, itemsize, spec in zip(*leaves, specs):
            shards = 1
            for ax in spec:
                for a in (() if ax is None else
                          ax if isinstance(ax, tuple) else (ax,)):
                    shards *= axis[a]
            total += int(np.prod(shape)) * itemsize // shards
        return total

    pshapes = _param_shapes(cfg)
    got = per_device(([tuple(t.shape) for t in tree_leaves(pshapes)],
                      [t.element_size() for t in tree_leaves(pshapes)]),
                     _specs(sh.param_specs(rules, pshapes)))
    jp = _j_param_shapes(jcfg)
    want = per_device(([tuple(t.shape) for t in jax.tree_util.tree_leaves(
        jp)], [t.dtype.itemsize for t in jax.tree_util.tree_leaves(jp)]),
        _j_specs(jsh.param_specs(jrules, jp)))
    assert got == want
    assert got < 4 * 2**30, got / 2**30


@pytest.mark.parametrize("arch", ["smollm-360m", "nemotron-4-340b"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_specs_match_jax(arch, opt):
    """(d): AdamW's moments mirror the parameters, Adafactor's factored
    statistics keep the leading entries: leaf for leaf JAX's."""
    cfg = get_reduced(arch) if arch == "smollm-360m" else get_config(arch)
    jcfg = j_get_reduced(arch) if arch == "smollm-360m" \
        else j_get_config(arch)
    rules, jrules = _rules(cfg, jcfg, "single")
    t_opt, j_opt = {"adamw": (adamw(1e-3), j_adamw(1e-3)),
                    "adafactor": (adafactor(1e-3), j_adafactor(1e-3))}[opt]
    pshapes = _param_shapes(cfg)
    ospecs = sh.opt_specs(rules, t_opt.init(tree_leaves(pshapes)),
                          sh.param_specs(rules, pshapes))
    jp = _j_param_shapes(jcfg)
    j_ospecs = jsh.opt_specs(jrules, jax.eval_shape(j_opt.init, jp),
                             jsh.param_specs(jrules, jp))
    assert _specs(ospecs) == _j_specs(j_ospecs)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_match_jax(arch):
    """(e): batch and decode-cache specs for the four input shapes on both
    meshes, each shape's cache at its batch and capacity."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        vcfg = steps.shape_variant(cfg, shape)
        cap = steps.cache_capacity(vcfg, shape)
        prefill = min(shape.seq_len, cap) - 1
        cache = lm.init_cache(vcfg, shape.global_batch, cap,
                              prefill_len=prefill, device="meta")
        jvcfg = jsteps.shape_variant(jcfg, jshape)
        jcache = jax.eval_shape(lambda: jlm.init_cache(
            jvcfg, jshape.global_batch, cap, prefill_len=prefill))
        for kind in MESHES:
            rules, jrules = _rules(cfg, jcfg, kind)
            got = sh.batch_specs(rules, cfg, shape)
            want = jsh.batch_specs(jrules, jcfg, jshape)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
            assert _specs(sh.cache_specs(rules, vcfg, cache,
                                         shape.global_batch)) == \
                _j_specs(jsh.cache_specs(jrules, jvcfg, jcache,
                                         jshape.global_batch))


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch):
    """``input_specs``' meta-device stand-ins: JAX's ShapeDtypeStructs'
    shapes and dtypes leaf for leaf, every input shape (the decode cache
    at the shape's capacity, the long-context window applied)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, J_SHAPES[name])
        leaves = tree_leaves(got)
        jleaves = jax.tree_util.tree_leaves(want)
        assert [tuple(t.shape) for t in leaves] == \
            [tuple(t.shape) for t in jleaves], name
        assert [str(t.dtype).split(".")[-1] for t in leaves] == \
            [str(t.dtype) for t in jleaves], name
        assert all(t.is_meta for t in leaves)


def test_placements_lay_dp_tuples_on_each_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, None), mesh) == (Replicate(),) * 3
    one = make_abstract_mesh((1, 4), ("data", "model"))
    assert sh.placements(sh.P("data", "model"), one) == (Replicate(),
                                                          Shard(1))


# -- (f) the census ---------------------------------------------------------------

@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_census_counts_a_loop_exactly():
    """(f): five (8×16)·(16×16) products: 5 · 2·8·16·16 = 20,480 FLOPs."""
    def loop(a, b):
        for _ in range(5):
            a @ b
    rec = census(loop, torch.ones(8, 16), torch.ones(16, 16))
    assert rec["flops"] == 20_480
    assert rec["collective_total"] == 0


def test_census_counts_one_ranks_share(fake_world):
    """(f): a column-parallel (64×1024)·(1024×4096) product on (16, 16):
    rank 0 multiplies (4×1024)·(1024×256), 2·4·1024·256 = 2,097,152 FLOPs,
    not the global 2·64·1024·4096; a Partial → Replicate of a (4, 1024)
    fp32 output is one all-reduce of 16,384 bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                             "model"))
    x = DTensor.from_local(torch.empty(4, 1024, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(1024, 256, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    for _ in range(2):       # the first call also propagates shardings
        rec = census(lambda: x @ w)
        assert rec["flops"] == 2 * 4 * 1024 * 256
        assert rec["collective_total"] == 0
    p = DTensor.from_local(torch.empty(4, 1024, device="meta"), mesh,
                           [Replicate(), Partial()], run_check=False)
    rec = census(lambda: p.redistribute(mesh, [Replicate(), Replicate()]))
    assert rec["collective_bytes"]["all-reduce"] == 16_384
    assert rec["collective_total"] == 16_384
    assert rec["collective_ops"]["all-reduce"] == 1


@pytest.fixture
def fake_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
                                  "hymba-1.5b", "llama-3.2-vision-11b",
                                  "whisper-tiny"])
def test_each_family_decodes_on_a_2x2_mesh(arch, fake_2x2):
    """The families (h) leaves out: a decode step on DTensor leaves laid
    out by the rules on (data=2, model=2), traced on meta shards of a
    fake world (no values; (h) checks values): every op has a rule or
    runs on replicas, FLOPs counted.  Their prefills are left out: the
    first dispatch of each new op costs DTensor seconds here."""
    rec = steps.build_step(get_reduced(arch), InputShape("t", "decode", 16,
                                                         4),
                           fake_2x2).trace()
    assert rec["flops"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0


# -- (g) the census against JAX's -------------------------------------------------

@pytest.fixture(scope="module")
def host_mesh():
    mesh = make_host_mesh("cpu")       # a gloo world of one
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


CENSUS_RATIOS: dict = {}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "mamba2-1.3b"])
def test_census_flops_match_jax(arch, kind, host_mesh):
    """(g): the census FLOPs of ``bundle.trace()`` on a 1×1 mesh within
    5 % of ``hlo_census`` of JAX's jitted step (B 4, S 64; the train step
    2 microbatches with remat).  The ratio is recorded."""
    B, S = 4, 64
    mb = 2 if kind == "train" else None
    jb = jsteps.build_step(j_get_reduced(arch), JInputShape("t", kind, S, B),
                           j_abstract_mesh((1, 1), ("data", "model")),
                           microbatches=mb)
    hlo = jax.jit(jb.fn).lower(*jb.abstract_inputs).compile().as_text()
    want = j_census(hlo)["flops"]
    bundle = steps.build_step(get_reduced(arch), InputShape("t", kind, S, B),
                              host_mesh, microbatches=mb)
    assert bundle.cfg.remat
    rec = bundle.trace()
    ratio = rec["flops"] / want
    CENSUS_RATIOS[(arch, kind)] = ratio
    print(f"census {arch} {kind}: port {rec['flops']:.0f} JAX {want:.0f} "
          f"ratio {ratio:.4f}")
    assert abs(ratio - 1) <= 0.05, ratio
    assert rec["collective_total"] == 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0


# -- (h) a 4-rank gloo world -------------------------------------------------------

class _Ranks:
    """``nprocs`` spawned ranks of ``fn``; rank 0's result off a queue."""

    def __init__(self, fn, nprocs, tmp, *args):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.procs = [ctx.Process(target=fn, args=(r, str(tmp / "store"))
                                  + args + (self.q,))
                      for r in range(nprocs)]
        for p in self.procs:
            p.start()

    def result(self):
        try:
            res = self.q.get(timeout=600)
        finally:
            for p in self.procs:
                p.join(timeout=120)
        assert all(p.exitcode == 0 for p in self.procs), \
            [p.exitcode for p in self.procs]
        return res

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The process-based checks (h) and (j), started before the others so
    that they run beside them."""
    tmp = tmp_path_factory.mktemp("worlds")
    ranks = _Ranks(workers.steps_on_2x2, 4, tmp,
                   ["smollm-360m", "deepseek-v2-lite-16b"])
    code = ("import json; from repro_torch.launch.dryrun import run_one; "
            "print(json.dumps(run_one('smollm-360m', 'decode_32k', "
            "'single')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out, err = open(tmp / "dry.out", "w+"), open(tmp / "dry.err", "w+")
    dry = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                           stdout=out, stderr=err, text=True)
    try:
        yield {"2x2": ranks, "dryrun": (dry, out, err)}
    finally:
        ranks.stop()
        if dry.poll() is None:
            dry.kill()
        dry.wait(timeout=30)
        out.close()
        err.close()


@pytest.fixture(scope="module")
def two_by_two(started):
    return started["2x2"].result()


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_steps_on_a_2x2_gloo_world(arch, two_by_two):
    """(h): on (data=2, model=2), against the single-device port: the
    loss within LOSS_TOL; each gradient leaf (AdamW's first moment over
    1 − b1 after one step from zeros) within GRAD_TOL of its largest |g|
    (floored at 1e-3 of the largest over the leaves); each updated
    parameter within the AdamW bound of tests/test_torch_lm_train.py,
    lr·min(2, 3·GRAD_TOL·scale/(√v̂ + eps)) + 1e-7; logits of the
    prefill and of each of 4 decode steps within LOGIT_TOL of the
    largest |logit|."""
    r = two_by_two[arch]
    got, want = r["train"]["loss"]
    assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want))
    g_got = [m / 0.1 for m in r["train"]["mu"][0]]
    g_want = [m / 0.1 for m in r["train"]["mu"][1]]
    floor = 1e-3 * max(float(np.abs(g).max()) for g in g_want)
    for g, w in zip(g_got, g_want):
        scale = max(float(np.abs(w).max()), floor)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale
    lr = 3e-4                                 # make_optimizer's AdamW
    for p, q, w, nu in zip(*r["train"]["params"], g_want, r["train"]["nu0"]):
        scale = max(float(np.abs(w).max()), floor)
        sqrt_v = np.sqrt(nu / (1 - 0.999))
        bound = lr * np.minimum(2.0, 3 * GRAD_TOL * scale
                                / (sqrt_v + 1e-8)) + 1e-7
        assert (np.abs(p - q) <= bound).all()
    for got, want in [r["prefill"]] + r["decode"]:
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


# -- (i) the federated round -------------------------------------------------------

FED = {"arch": "smollm-360m", "silos": 2, "local_steps": 2, "batch": 2,
       "seq": 16, "topk": 0.2}


@pytest.fixture(scope="module")
def fed_inputs():
    """JAX's anchor (``init_params`` at PRNGKey(0)) and AdamW state
    stacked over two silos, each silo's batches from its own seed; the
    same as the port's tensors."""
    arch, S, L = FED["arch"], FED["silos"], FED["local_steps"]
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jp = jax.jit(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))()
    jo = j_adamw(1e-3).init(jp)

    def stack(t):
        return jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (S,) + a.shape), t)

    gens = [synthetic_batches(cfg, batch=FED["batch"], seq=FED["seq"],
                              seed=s, device="cpu") for s in range(S)]
    per = [[next(g) for _ in range(L)] for g in gens]
    batches = {k: torch.stack([torch.stack([b[k] for b in s]) for s in per])
               for k in ("tokens", "labels")}
    anchor = lm.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                device="cpu")
    stacked = replicate(anchor, S)
    state = from_jax_opt_state(
        jax.tree_util.tree_map(np.asarray, stack(jo)), stacked)
    jfn, _, _ = j_build_fed_round(
        jcfg, j_abstract_mesh((S, 1, 1), ("pod", "data", "model")),
        local_steps=L, topk=FED["topk"], batch=FED["batch"], seq=FED["seq"])
    j_anchor, j_loss = jax.jit(jfn)(
        stack(jp), stack(jo), jp,
        {k: jnp.asarray(v.numpy()) for k, v in batches.items()})
    fn, _, _ = build_fed_round(
        cfg, make_abstract_mesh((S, 1, 1), ("pod", "data", "model")),
        local_steps=L, topk=FED["topk"], batch=FED["batch"], seq=FED["seq"])
    args = (stacked, state, anchor, batches)
    new, loss = fn(*args)
    return {"args": args, "anchor": anchor, "new": new, "loss": float(loss),
            "j_anchor": [np.asarray(t) for t in
                         jax.tree_util.tree_leaves(j_anchor)],
            "j_loss": float(j_loss)}


def test_fed_round_matches_jax(fed_inputs):
    """(i): the loss within LOSS_TOL; the new anchor within FED_TOL of
    each leaf's largest |value| except (1) entries top-k kept in one
    package and dropped in the other, which must sit at the threshold
    (their delta within 1e-3 of the smallest delta JAX kept in the leaf),
    and (2) entries where AdamW's second local step turned a rounding
    difference of a near-zero second moment into a visible one (see
    tests/test_torch_lm_train.py): kept by both, within the AdamW step
    2·lr·local_steps, and few — under 1e-3 of the entries overall and
    max(2, 1e-3 of the leaf) in each leaf.  Both counts are printed."""
    f = fed_inputs
    assert abs(f["loss"] - f["j_loss"]) <= LOSS_TOL * abs(f["j_loss"])
    ties, conditioned, total = {}, {}, 0
    for path, g, w, a in zip(tree_paths(f["new"]), tree_leaves(f["new"]),
                             f["j_anchor"], tree_leaves(f["anchor"])):
        g, a = g.numpy(), a.numpy()
        total += g.size
        off = np.abs(g - w) > FED_TOL * np.abs(w).max()
        if not off.any():
            continue
        dg, dw = g - a, w - a
        tie = off & ((dg == 0) != (dw == 0))
        if tie.any():
            thr = np.abs(dw[dw != 0]).min()
            np.testing.assert_allclose(
                np.maximum(np.abs(dg), np.abs(dw))[tie], thr, rtol=1e-3)
            ties[path] = int(tie.sum())
        rest = off & ~tie
        if rest.any():
            assert (np.abs(g - w)[rest] <= 2 * 1e-3 * FED["local_steps"]).all()
            assert rest.sum() <= max(2, 1e-3 * g.size), (path, rest.sum())
            conditioned[path] = int(rest.sum())
    assert sum(conditioned.values()) < 1e-3 * total
    print(f"fed round: threshold ties {ties}, AdamW-conditioned "
          f"{conditioned} of {total} entries")


def test_fed_round_on_a_pod_world_equals_plain(fed_inputs, tmp_path):
    """(i): (pod=2, data=1, model=1) over 2 gloo ranks, each pod one
    silo and the delta sum an all-reduce over pod: the new anchor and
    the loss equal to the plain round's bit for bit."""
    f = fed_inputs
    inputs = {"args": f["args"], "local_steps": FED["local_steps"],
              "batch": FED["batch"], "seq": FED["seq"]}
    anchor, loss = _Ranks(workers.fed_round_on_pods, 2, tmp_path,
                          FED["arch"], inputs, FED["topk"]).result()
    assert loss == f["loss"]
    for got, want in zip(anchor, tree_leaves(f["new"])):
        np.testing.assert_array_equal(got, want.numpy())


# -- (j) the dry-run ---------------------------------------------------------------

def test_dryrun_run_one_in_its_own_process(started):
    """(j): ``run_one("smollm-360m", "decode_32k", "single")`` in a process
    of its own (its fake world of 256 ranks): ok, with JAX's FSDP and
    sequence-parallel switches and a census of one rank's work."""
    proc, out, err = started["dryrun"]
    assert proc.wait(timeout=300) == 0, err.seek(0) or err.read()[-2000:]
    out.seek(0)
    rec = json.loads(out.read().strip().splitlines()[-1])
    assert rec["ok"], rec.get("error")
    jrules = jsh.make_rules(j_abstract_mesh(*MESHES["single"]),
                            j_get_config("smollm-360m"))
    assert (rec["fsdp"], rec["seq_parallel"]) == (jrules.fsdp,
                                                  jrules.seq_parallel)
    assert rec["devices"] == 256
    assert rec["census"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
