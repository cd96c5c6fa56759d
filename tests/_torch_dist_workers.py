"""Rank bodies of ``tests/test_torch_distributed.py``'s gloo worlds.

A module of its own, importing no JAX, so that each spawned rank starts
quickly; each rank joins a gloo world over a ``FileStore`` (no ports)
and rank 0 puts its results on a queue."""

import torch
import torch.distributed as dist


def _join(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def _np(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t) \
        .detach().numpy().copy()


def steps_on_2x2(rank: int, store_path: str, archs: list, out) -> None:
    """(data=2, model=2): ``build_step``'s train step, prefill and four
    decode steps of each reduced arch, each beside the single-device port
    on the same inputs.  Rank 0 reports numpy copies of both."""
    _join(rank, 4, store_path)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, make_optimizer
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    mesh = make_mesh((2, 2), ("data", "model"))
    B, S, MB = 4, 16, 2
    res = {}
    for arch in archs:
        cfg = get_reduced(arch)
        batch = next(synthetic_batches(cfg, batch=B, seq=S, seed=3,
                                       device="cpu"))
        params = lm.init_params(cfg, generator=torch.Generator()
                                .manual_seed(1), device="cpu")
        r = {}
        train = build_step(cfg, InputShape("t", "train", S, B), mesh,
                           microbatches=MB)
        opt = make_optimizer(train.cfg)
        state = opt.init(tree_leaves(params))
        p1, s1, m1 = train.run(params, state, batch)
        p0, s0, m0 = lm.make_train_step(train.cfg, opt, microbatches=MB)(
            params, state, batch)
        r["train"] = {"loss": (float(_np(m1["loss"])), float(m0["loss"])),
                      "params": ([_np(t) for t in tree_leaves(p1)],
                                 [_np(t) for t in tree_leaves(p0)]),
                      "mu": ([_np(t) for t in s1.mu],
                             [_np(t) for t in s0.mu]),
                      "nu0": [_np(t) for t in s0.nu]}
        prefill = build_step(cfg, InputShape("t", "prefill", S, B), mesh)
        fwd = {"tokens": batch["tokens"]}
        r["prefill"] = (_np(prefill.run(params, fwd)),
                        _np(lm.forward(params, prefill.cfg, fwd)[0]))
        decode = build_step(cfg, InputShape("t", "decode", S, B), mesh)
        c1 = lm.init_cache(decode.cfg, B, S, device="cpu")
        c0 = lm.init_cache(decode.cfg, B, S, device="cpu")
        r["decode"] = []
        for i in range(4):
            tok = batch["tokens"][:, i:i + 1]
            l1, c1 = decode.run(params, tok, c1)
            l0, c0 = lm.decode_step(params, decode.cfg, tok, c0)
            r["decode"].append((_np(l1), _np(l0)))
        res[arch] = r
    if rank == 0:
        out.put(res)
    dist.destroy_process_group()


def fed_round_on_pods(rank: int, store_path: str, arch: str, inputs: dict,
                      topk: float, out) -> None:
    """(pod=2, data=1, model=1): ``build_fed_round`` on the silos laid out
    over the pods.  Rank 0 reports the new anchor and the loss."""
    _join(rank, 2, store_path)
    from repro_torch.configs import get_reduced
    from repro_torch.launch.fedrun import build_fed_round
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import lay_out
    from repro_torch.tree import tree_leaves

    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    fn, placements, _ = build_fed_round(
        get_reduced(arch), mesh, local_steps=inputs["local_steps"],
        topk=topk, batch=inputs["batch"], seq=inputs["seq"])
    args = [lay_out(mesh, x, pl) for x, pl in
            zip(inputs["args"], placements)]
    anchor, loss = fn(*args)
    if rank == 0:
        out.put(([_np(t) for t in tree_leaves(anchor)], float(_np(loss))))
    dist.destroy_process_group()
