"""Ranks of the port's sequence- and data-parallel tests: each a spawned
process on the CPU, joined over gloo (`torch.distributed`), importing
nothing of JAX. A test module spawns its ranks once (`spawn`) and reads
what they wrote into its work directory."""

import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, workdir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, workdir, payload)
    except BaseException:
        with open(os.path.join(workdir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world, workdir, payload):
    """Run fn(rank, world, workdir, payload) on `world` gloo ranks (CPU)."""
    mp.spawn(_entry, args=(world, _free_port(), fn, str(workdir), payload), nprocs=world,
             join=True)


# ------------------------------------------------------------------ the ring


def ring_inputs(case):
    """A ring case's global inputs in slot order, numpy fp32: q, k, v, the
    cotangent, a per-key bias [b, 1, 1, S] (holes away from document
    starts, so every query sees a key) and segment ids [b, S] of three
    documents over the positions."""
    world, layout, h, h_kv, s_local, d, seed = (case[k] for k in (
        "world", "layout", "h", "h_kv", "s_local", "d", "seed"))
    b, seq = 2, world * s_local
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, seq, h, d), np.float32)
    k = rng.standard_normal((b, seq, h_kv, d), np.float32)
    v = rng.standard_normal((b, seq, h_kv, d), np.float32)
    g = rng.standard_normal((b, seq, h, d), np.float32)
    from lwm_tpu_torch.ops.striped import stripe_positions

    pos = stripe_positions(seq, world) if layout == "striped" else np.arange(seq)
    cuts = np.asarray([[seq // 3, 2 * seq // 3], [seq // 5, seq // 2]])
    segs = ((pos[None] >= cuts[:, :1]).astype(np.int32)
            + (pos[None] >= cuts[:, 1:]).astype(np.int32))
    seg_pos = segs[:, np.argsort(pos)]                   # in position order
    first = np.concatenate([np.ones((b, 1), bool), seg_pos[:, 1:] != seg_pos[:, :-1]], 1)
    holes_pos = (rng.random((b, seq)) < 0.15) & ~first
    holes = holes_pos[:, pos]
    bias = np.where(holes, -1e30, 0.1 * rng.standard_normal((b, seq))).astype(np.float32)
    return q, k, v, g, bias[:, None, None, :], segs


def ring_ranks(rank, world, workdir, cases):
    """Each case's port ring over its first `case["world"]` ranks: out, dq,
    dk, dv of this rank's slice, written to workdir."""
    from lwm_tpu_torch.ops.ring import ring_attention

    groups = {w: dist.new_group(list(range(w))) for w in sorted({c["world"] for c in cases})}
    for i, case in enumerate(cases):
        w = case["world"]
        if rank >= w:
            continue
        q, k, v, g, bias, segs = ring_inputs(case)
        s = case["s_local"]
        sl = slice(rank * s, (rank + 1) * s)
        qt, kt, vt = (torch.from_numpy(x[:, sl]).requires_grad_() for x in (q, k, v))
        out = ring_attention(qt, kt, vt, torch.from_numpy(bias), torch.from_numpy(segs),
                             group=groups[w], layout=case["layout"])
        out.backward(torch.from_numpy(g[:, sl]))
        np.savez(os.path.join(workdir, f"ring{i}_rank{rank}.npz"), out=out.detach().numpy(),
                 dq=qt.grad.numpy(), dk=kt.grad.numpy(), dv=vt.grad.numpy())


# ------------------------------------------------------------- the trainer


def train_mesh_ranks(rank, world, workdir, payload):
    """The port's train step at each of payload["runs"] (mesh_dim, layout)
    from the saved initial state dict: loss, accuracy and gradients of the
    whole batch (summed over the ranks), then the metrics and parameters
    after one AdamW step; rank 0 writes them, every rank its parameters'
    checksum."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    init = torch.load(os.path.join(workdir, "init.pt"))
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    cfg = LLaMAConfig.from_dict(payload["config"])
    for i, (mesh_dim, layout) in enumerate(payload["runs"]):
        mesh = create_mesh(mesh_dim, "cpu", layout)
        part = train._on_device(batch, "cpu", get_ranks_and_size(mesh))
        model = LLaMAForCausalLM(cfg, device="cpu")
        model.load_state_dict(init)
        model.mesh = mesh
        state = train.create_train_state(model, payload["optimizer"])
        loss, aux = train.compute_loss(model, part)
        loss.backward()
        train.all_reduce_grads(list(model.parameters()), mesh.group())
        grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        metrics = train.train_step(state, part)
        params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        np.save(os.path.join(workdir, f"run{i}_rank{rank}_sum.npy"),
                np.asarray([float(np.abs(v).sum()) for v in params.values()]))
        if rank == 0:
            np.savez(os.path.join(workdir, f"run{i}.npz"), loss=loss.item(), acc=aux["acc"].item(),
                     **{f"grad/{n}": v for n, v in grads.items()},
                     **{f"param/{n}": v for n, v in params.items()},
                     **{f"metric/{k}": v.item() for k, v in metrics.items()})


def train_mesh_vision_ranks(rank, world, workdir, payload):
    """A VideoLLaMA's loss (the dual loss), its metrics and its gradients
    summed over the ranks, at each of payload["runs"]; rank 0 writes them."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    init = torch.load(os.path.join(workdir, "vision_init.pt"))
    batch = dict(np.load(os.path.join(workdir, "vision_batch.npz")))
    cfg = VideoLLaMAConfig.from_dict(payload["config"])
    for i, (mesh_dim, layout) in enumerate(payload["runs"]):
        mesh = create_mesh(mesh_dim, "cpu", layout)
        model = VideoLLaMAForCausalLM(cfg, device="cpu")
        model.load_state_dict(init)
        model.mesh = mesh
        loss, aux = train.compute_loss(model, train._on_device(batch, "cpu",
                                                              get_ranks_and_size(mesh)))
        loss.backward()
        train.all_reduce_grads(list(model.parameters()), mesh.group())
        if rank == 0:
            np.savez(os.path.join(workdir, f"vision{i}.npz"), loss=loss.item(),
                     **{f"metric/{k}": v.item() for k, v in aux.items()},
                     **{f"grad/{n}": p.grad.numpy() for n, p in model.named_parameters()})


def train_mesh_all_ranks(rank, world, workdir, payload):
    """`train_mesh_ranks`, then `train_mesh_vision_ranks` on payload["vision"]."""
    train_mesh_ranks(rank, world, workdir, payload)
    train_mesh_vision_ranks(rank, world, workdir, payload["vision"])


def train_cli_ranks(rank, world, workdir, argv):
    """The training CLI on every rank (gloo, the CPU)."""
    from lwm_tpu_torch import train

    summary = train.main(list(argv))
    with open(os.path.join(workdir, f"cli_rank{rank}.txt"), "w") as f:
        f.write(summary["output_dir"])
